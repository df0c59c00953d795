"""The sign codec's share of its HBM roofline: the bytes of one pack and
one unpack (``yardstick.sign_codec_bytes``) at 3.35 TB/s for each pack
launch, over the device time of the pack and unpack kernels."""
from bench import tracing, yardstick


def read(trace):
    runs = [d for d in trace.dev if tracing.kind(d[0], d[1]) == "sign_codec"]
    packs = sum(1 for d in runs if "sign_pack" in d[0])
    if not packs:
        return None
    ms = sum(d[3] - d[2] for d in runs) * 1e-3
    bound = yardstick.bound_ms(yardstick.sign_codec_bytes(
        trace.workers, trace.elems, trace.blocks), trace.peaks)
    return 100.0 * bound * packs / ms

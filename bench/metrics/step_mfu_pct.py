"""The whole step's share of the card's peak: the model's FLOPs a token
(``yardstick.model_flops_per_token``) times the tokens trained on in the
traced window, over the window's wall time, over the data sheet's peak in
the configuration's compute precision (f32 with TF32 off: 67 TFLOP/s)."""
from bench import yardstick

PEAK_OF = {"float32": "f32_flops_per_s", "bfloat16": "bf16_flops_per_s"}


def read(trace):
    if trace.tokens <= 0 or trace.window_s <= 0:
        return None
    flops = yardstick.model_flops_per_token(trace.model, trace.seq)
    peak = trace.peaks[PEAK_OF[trace.model["compute_dtype"]]]
    return 100.0 * flops * trace.tokens / trace.window_s / peak

"""The byte claims of the reference's wire benchmarks, held in the port.

``benchmarks/wire_codecs.py`` drives CPD-SGDM over a ragged 16-leaf tree
(K = 4 on a ring) with each wire codec, and ``benchmarks/embedding_wire.py``
prices the sparse-rows codec on embedding tables of 4,096, 16,384 and
65,536 rows × 64 at a budget of 64 rows.  Their bytes are payload
arithmetic, committed in ``benchmarks/BENCH_wire_codecs.json`` and
``benchmarks/BENCH_embedding.json``.  The port's accounting must give the
same numbers, exactly; they are read from those files here.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (CPDSGDM, CPDSGDMConfig, DenseComm,  # noqa: E402
                              IdentityCompressor, QSGDCompressor,
                              RandKCompressor, SignCompressor,
                              SparseRowsCompressor, TopKCompressor,
                              make_codec, ring)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks")
# benchmarks/wire_codecs.py: CODECS and the ragged tree of _params()
CODECS = {"identity": IdentityCompressor(), "sign": SignCompressor(),
          "topk": TopKCompressor(fraction=0.01),
          "randk": RandKCompressor(fraction=0.01),
          "qsgd": QSGDCompressor(levels=7)}
SHAPES = [(257, 129), (64, 300), (1000,), (33, 65), (7, 11, 13), (2048,),
          (129,), (301, 5)] * 2


def _committed(name: str) -> dict:
    with open(os.path.join(BENCH, f"BENCH_{name}.json")) as f:
        return {row["name"]: row["derived"] for row in json.load(f)["rows"]}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_wire_codecs_bytes_per_round(codec):
    """identity 962,896; sign 32,736; topk 21,824; randk 9,696; qsgd
    127,968 B per worker per round, as committed."""
    want = _committed("wire_codecs")[f"wire_codecs/{codec}"]
    tree = {f"w{i}": torch.zeros(s) for i, s in enumerate(SHAPES)}
    opt = CPDSGDM(CPDSGDMConfig(eta=0.05, mu=0.9, p=4, gamma=0.4,
                                weight_decay=1e-4),
                  DenseComm(ring(4), device="cpu"), CODECS[codec])
    assert opt.bytes_per_comm_round(tree) == want["bytes_per_round"]
    assert opt.bytes_per_round_cycle(tree) == (want["bytes_per_round"],)


@pytest.mark.parametrize("rows", [4096, 16384, 65536])
def test_embedding_bytes_flat_in_table_size(rows):
    """262,400 B per leaf at a budget of 64 rows, whatever the table's
    size; and a ring round of the 4,096-row table ships two of them."""
    want = _committed("embedding")
    codec = make_codec(SparseRowsCompressor(max_rows=64))
    assert codec.wire_bytes(rows * 64) == \
        want[f"embedding/table{rows}"]["bytes_per_leaf"] == 262_400
    opt = CPDSGDM(CPDSGDMConfig(eta=0.05, mu=0.9, p=4, gamma=0.4),
                  DenseComm(ring(4), device="cpu"),
                  SparseRowsCompressor(max_rows=64))
    assert opt.bytes_per_comm_round({"table": torch.zeros((rows, 64))}) == \
        want["embedding/round_sparse"]["bytes_per_round"]

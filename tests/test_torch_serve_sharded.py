"""The port's sharded serving (``repro_torch.launch.runtime.build_serve``)
on gloo ranks on the CPU, against one rank's ``generate``.

The ranks are spawned once (``tests/torch_serve_ranks.py`` holds their
side; it imports no JAX) on a serving mesh of 2 (``"data"``) × 2
(``"model"``): profile A (TP over ``"model"``, the batch over
``"data"``) and profile B (FSDP over ``"data"`` beside TP), and once on
an FSDP axis of 4 alone.  Params come from the reference's ``init``
through ``params_from_reference``, prompts from a numpy seed.  Each case
holds, on every rank:

* ``ServePack.generate``'s greedy tokens equal one rank's ``generate``'s
  exactly (the whole batch on every rank);
* the gathered logits of the prefill and of each teacher-forced decode
  step within atol 1e-5, rtol 1e-5 of one rank's (TP sums the heads' and
  the FFN's partial products in another order);
* the rank's cache after the prefill equals its piece of one rank's
  (``CachePlan.shard``: its rows, its KV or SSD heads, the conv window's
  x channels beside B and C whole, MLA's latents and ``pos`` whole): K/V,
  latents and states within the same bar, ``pos`` exactly;
* where the batch does not divide over the batch axes (b = 3 on 2 data
  ranks), every rank holds the whole batch and its whole cache.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import make_model as r_make_model  # noqa: E402
from repro.configs.registry import get_smoke_config as r_smoke  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.spawn import spawn_ranks  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.serve.serving import generate  # noqa: E402

import torch_serve_ranks  # noqa: E402

ATOL = RTOL = 1e-5
PROMPT, NEW, MAX_LEN = 8, 6, 16
DATA_MODEL = ((2,), ("data",), 2)
# name: (arch, profile, batch, mesh, config overrides)
CASES = {
    "a_tp2_dp2": ("olmo-1b", "A", 4, DATA_MODEL, {}),
    "a_batch_not_dividing": ("olmo-1b", "A", 3, DATA_MODEL, {}),
    "b_fsdp_tp_ring_moe": ("mixtral-8x7b", "B", 4, DATA_MODEL,
                           {"window": 8}),
    "b_batch_not_dividing": ("mixtral-8x7b", "B", 3, DATA_MODEL, {}),
    "a_mla": ("minicpm3-4b", "A", 4, DATA_MODEL, {}),
    "a_ssd": ("mamba2-1.3b", "A", 4, DATA_MODEL, {}),
    "b_hybrid": ("jamba-1.5-large-398b", "B", 4, DATA_MODEL, {}),
    "b_fsdp4_qkv_bias": ("qwen2-72b", "B", 4, ((4,), ("data",), 1), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name: str):
    arch, profile, b, mesh, over = CASES[name]
    rcfg = dataclasses.replace(r_smoke(arch).model, **over)
    cfg = dataclasses.replace(get_smoke_config(arch).model, **over)
    rparams = jax.tree_util.tree_map(
        np.asarray, r_make_model(rcfg).init(jax.random.PRNGKey(0)))
    params = params_from_reference(rparams, "cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (b, PROMPT)).astype(np.int32)
    return {"mesh": mesh, "profile": profile, "cfg": cfg,
            "params": {k: v.numpy() for k, v in params.items()},
            "prompt": prompt, "max_new": NEW, "max_len": MAX_LEN}


def _one_rank(case: dict) -> dict:
    """One rank's generate, and its prefill and teacher-forced decode."""
    model = make_model(case["cfg"])
    params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    prompt = torch.from_numpy(case["prompt"])
    toks = generate(model, params, prompt, NEW, max_len=MAX_LEN)
    with torch.inference_mode():
        lg, cache = model.prefill_fast(params, {"tokens": prompt},
                                       max_len=MAX_LEN)
        first = {p: {k: v.clone() for k, v in c.items()}
                 for p, c in cache.items()}
        logits = [lg]
        for i in range(NEW - 1):
            lg, cache = model.decode_step(params, cache, toks[:, PROMPT + i],
                                          PROMPT + i, max_positions=MAX_LEN)
            logits.append(lg)
    return {"tokens": toks.numpy(), "logits": torch.stack(logits).numpy(),
            "cache": first}


@pytest.fixture(scope="module")
def served():
    cases = {name: _case(name) for name in CASES}
    ranks = spawn_ranks(torch_serve_ranks.serve_cases, 4,
                        ([cases[n] for n in CASES],), backend="gloo",
                        device="cpu")
    return {name: (cases[name], _one_rank(cases[name]),
                   [r[j] for r in ranks])
            for j, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_tokens_equal_one_rank(served, name):
    _, one, ranks = served[name]
    for got in ranks:
        np.testing.assert_array_equal(got["tokens"], one["tokens"])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_logits_within_bar_of_one_rank(served, name):
    _, one, ranks = served[name]
    for got in ranks:
        np.testing.assert_allclose(got["logits"], one["logits"], atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_cache_is_its_piece_of_one_rank(served, name):
    case, one, ranks = served[name]
    b = case["prompt"].shape[0]
    for got in ranks:
        plan = got["plan"]
        divides = b % plan.batch_size == 0
        assert plan.batch_split == divides
        lo, hi = got["rows"]
        assert (lo, hi) == ((plan.batch_index * b // plan.batch_size,
                             (plan.batch_index + 1) * b // plan.batch_size)
                            if divides else (0, b))
        want = plan.shard(one["cache"])
        assert set(got["cache"]) == set(want)
        for pos, leaves in want.items():
            for leaf, w in leaves.items():
                g = got["cache"][pos][leaf]
                assert g.shape == tuple(w.shape) == got["cache_shapes"][
                    pos][leaf], (pos, leaf)
                if leaf == "pos":
                    np.testing.assert_array_equal(g, w.numpy())
                else:
                    np.testing.assert_allclose(g, w.numpy(), atol=ATOL,
                                               rtol=RTOL)


def test_cache_plans_split_what_the_layout_says(served):
    """TP 2 splits GQA's KV heads and the SSD's heads and conv channels,
    never MLA's latents or ``pos``; an FSDP axis alone splits no head."""
    expect = {"a_tp2_dp2": {"k": -2, "v": -2, "pos": None},
              "a_mla": {"ckv": None, "krope": None, "pos": None},
              "a_ssd": {"ssm": -3, "conv": -1},
              "b_fsdp4_qkv_bias": {"k": None, "v": None, "pos": None}}
    for name, leaves in expect.items():
        plan = served[name][2][0]["plan"]
        for leaf, dim in leaves.items():
            split = plan.splits["pos0"][leaf]
            assert (split.dim if split is not None else None) == dim, (
                name, leaf)
    assert served["b_fsdp4_qkv_bias"][2][3]["plan"].batch_index == 3

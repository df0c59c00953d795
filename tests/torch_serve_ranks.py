"""Rank-side scenarios of ``tests/test_torch_serve_sharded.py``: each
function runs in every gloo rank on the CPU (spawned by
``repro_torch.launch.spawn.spawn_ranks``), builds the port's serving pack
(``build_serve``) on a serving mesh, serves the prompts handed over by the
test from the whole params handed over by it, and returns numpy results
for the test process to hold against one rank's ``generate``.  Imports
nothing of JAX."""
import numpy as np
import torch

from repro_torch.configs.base import ParallelCfg, RunCfg
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.runtime import build_serve


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def serve_case(mesh_rank, case: dict) -> dict:
    """One case: ``case["mesh"]`` ``(sizes, names, model_axis)``, its
    profile, config, whole params (numpy, the port's names), prompts and
    lengths.  Returns the tokens of ``ServePack.generate``, the gathered
    logits of the prefill and of each decode step (teacher-forced on the
    generated tokens), and this rank's cache after the prefill."""
    rank, world, dev = mesh_rank
    sizes, names, model_axis = case["mesh"]
    mesh = make_mesh(sizes, names, device=dev, model_axis=model_axis)
    run = RunCfg(model=case["cfg"],
                 parallel=ParallelCfg(profile=case["profile"]))
    prompt = torch.from_numpy(case["prompt"])
    b, s = prompt.shape
    pack = build_serve(run, mesh, InputShape("serve", case["max_len"], b,
                                             "decode"))
    plan = pack.model.plan
    params = {}
    for k, v in case["params"].items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        params[k] = (plan.shard(k, t) if plan is not None else t).clone()
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in pack.params_struct.items()}
    toks = pack.generate(params, prompt, case["max_new"])
    with torch.inference_mode():
        lg, cache = pack.prefill_step(params,
                                      {"tokens": pack.local(prompt)})
        first = {p: {k: v.clone() for k, v in c.items()}
                 for p, c in cache.items()}
        logits = [pack.gather(lg)]
        for i in range(case["max_new"] - 1):
            lg, cache = pack.decode_step(params, cache,
                                         pack.local(toks[:, s + i]), s + i)
            logits.append(pack.gather(lg))
    shapes = {p: {k: tuple(v.shape) for k, v in c.items()}
              for p, c in pack.cache_struct.items()}
    return {"tokens": toks.numpy(), "logits": np.stack([_np(t) for t in logits]),
            "cache": _np(first), "cache_shapes": shapes,
            "rows": (pack.rows.start, pack.rows.stop),
            "plan": pack.cache_plan}


def serve_cases(mesh_rank, cases: list) -> list:
    return [serve_case(mesh_rank, c) for c in cases]

"""The dry run: one round (or one prefill, or one decode step) of a
production configuration on the ``meta`` device, as rank 0 of a ``fake``
process group, with no card.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles the step against abstract inputs on 256 or 512 placeholder
devices and reads the compiled HLO.  The port runs the step itself on
meta tensors, which carry shapes and dtypes and no data, in a process of
its own (:func:`run_in_process`):

1. a ``fake`` group of 256 ranks (the ``(16, 16)`` mesh), or 512 with
   ``multi_pod`` (``(2, 16, 16)``), with this process as rank 0;
2. the port's mesh on it (``make_mesh``, the config's profile through
   ``make_layout``), every rank's groups built as the real run builds
   them;
3. ``build_train`` or ``build_serve`` on ``device="meta"``, and the step on
   meta batches (``train_batch_specs``), under the
   :class:`~repro_torch.analysis.collectives.CommRecorder` (every
   collective counted with its bytes, none posted) and :class:`LiveBytes`
   (each storage's bytes from the op that makes it until it is freed).

The record keeps the reference's fields: the analytic ones
(:func:`analytic_fields`, the reference's arithmetic), ``collective_*``
from the recorder, ``terms`` on the H100's ``HW``, ``memory`` (arguments:
the rank's params and state or cache and its batch; temps: the tracked
peak above them, each kernel wrapper counted as its CUDA kernel
allocates, :func:`kernel_scopes`; outputs; aliases: the output bytes
written in place)
and ``build_s`` in place of ``compile_s``.  The reference's
``compute_loop_trips`` has no counterpart: the recorder counts executed
calls.  Meta doubles as a host-sync check: a round that reads a value on
the host fails here.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --hier
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pickle
import tempfile
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import (ASSIGNED, get_config,
                                          long_ctx_variant, shape_supported)
from repro_torch.configs.shapes import SHAPES, InputShape, train_batch_specs
from repro_torch.launch.analytic import analytic_cost
from repro_torch.launch.mesh import WorkerMesh, make_layout
from repro_torch.launch.roofline import model_flops, roofline_terms

__all__ = ["LiveBytes", "analytic_fields", "main", "meta_step",
           "production_mesh", "run_in_process", "run_one"]

OUTDIR = "artifacts/dryrun_torch"


def production_mesh(multi_pod: bool):
    """``(named axis sizes, names, model axis)`` of the production mesh:
    ``(16, 16)`` as ("data", "model"), or ``(2, 16, 16)`` as ("pod",
    "data", "model")."""
    if multi_pod:
        return (2, 16), ("pod", "data"), 16
    return (16,), ("data",), 16


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def analytic_fields(run, mcfg, shape: InputShape, multi_pod: bool) -> dict:
    """The record's analytic fields, as the reference computes them: the
    chip and worker counts of the production mesh under the config's
    layout (``make_layout`` on the mesh's axes; one worker for serving),
    and ``analytic_cost``/``model_flops`` of the call."""
    sizes, names, tp = production_mesh(multi_pod)
    n_chips = int(math.prod(sizes)) * tp
    kind = shape.kind
    n_workers = 1
    if kind == "train":
        shell = WorkerMesh(names + ("model",), sizes + (tp,), 0,
                           torch.device("meta"), "fake")
        n_workers = make_layout(run.parallel, shell).n_workers
    p = run.optim.p
    ac = analytic_cost(mcfg, shape, kind, p, n_chips, n_workers,
                       run.parallel.remat)
    mf = model_flops(mcfg.active_params_count(), ac["tokens"], kind)
    return {"kind": kind, "n_chips": n_chips, "n_workers": n_workers,
            "profile": run.parallel.profile, "optimizer": run.optim.name,
            "p": p, "tokens_per_call": ac["tokens"],
            "flops_per_device": ac["flops_per_device"],
            "bytes_per_device": ac["bytes_per_device"],
            "model_flops": mf, "hlo_total_flops": ac["flops_total"],
            "useful_flops_ratio": (mf / ac["flops_total"])
            if ac["flops_total"] else 0.0}


# ------------------------------------------------------------------ memory
def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _storage_bytes(tree) -> int:
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages made inside the block and still alive,
    and their peak.  Each op's outputs add their storages' bytes the first
    time a storage is seen; a weak reference takes them off when the
    storage is freed.  :meth:`baseline` marks storages made before the
    block (the step's arguments), whose views count nothing.  ``written``:
    the storages an op wrote in place."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._refs = {}
        self._base = set()
        self.written = set()
        self.quiet = 0          # inside a kernel wrapper (kernel_scopes)

    def baseline(self, tree):
        for t in _tensors(tree):
            self._base.add(t.untyped_storage()._cdata)

    def _free(self, key, n):
        if self._refs.pop(key, None) is not None:
            self.live -= n
            # a later storage may take this address
            self.written.discard(key)

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if self.quiet or key in self._base or key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _r, key=key, n=n: self._free(key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        schema = func._schema
        if schema.is_mutable:
            for arg, val in zip(schema.arguments, args):
                if (arg.alias_info is not None and arg.alias_info.is_write
                        and isinstance(val, torch.Tensor)):
                    key = val.untyped_storage()._cdata
                    # inside a kernel wrapper only a write to what the
                    # caller handed it is the kernel's (its plain version's
                    # own temporaries are not)
                    if not self.quiet or key in self._refs or \
                            key in self._base:
                        self.written.add(key)
        return out

    def written_bytes(self, tree) -> int:
        """The bytes of ``tree``'s storages written in place."""
        seen = {}
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata in self.written:
                seen[st._cdata] = st.nbytes()
        return sum(seen.values())


# the kernel wrappers as the round calls them: module (under
# repro_torch.kernels) and name
KERNEL_ENTRIES = (("ops", "momentum_update"), ("ops", "gossip_mix"),
                  ("ops", "gossip_mix_shifted"),
                  ("sign_compress", "sign_pack"),
                  ("sign_compress", "sign_unpack"),
                  ("qsgd_quant", "qsgd_quant"),
                  ("qsgd_quant", "qsgd_dequant"),
                  ("topk_select", "topk_select"),
                  ("topk_select", "topk_scatter"),
                  ("row_gather", "row_gather"),
                  ("row_gather", "row_scatter"))


@contextlib.contextmanager
def kernel_scopes(live: LiveBytes):
    """Count a kernel wrapper's call as its CUDA kernel allocates: its
    outputs only.  On meta a wrapper runs its plain version, whose
    temporaries the kernel never makes (the in-place momentum's plain
    version holds four copies of the matrix at once); inside a wrapper
    ``live`` counts nothing, and what the wrapper returns is counted when
    it returns (an in-place result is its input's storage, counted
    already)."""
    import importlib
    saved = []
    for mod_name, fn_name in KERNEL_ENTRIES:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        inner = getattr(mod, fn_name)

        def scoped(*a, _inner=inner, **k):
            live.quiet += 1
            try:
                out = _inner(*a, **k)
            finally:
                live.quiet -= 1
            for t in _tensors(out):
                live._track(t)
            return out
        saved.append((mod, fn_name, inner))
        setattr(mod, fn_name, scoped)
    try:
        yield
    finally:
        for mod, fn_name, inner in saved:
            setattr(mod, fn_name, inner)


# ------------------------------------------------------------- the meta step
def _meta_like(tree):
    return {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def meta_step(run, mcfg, shape: InputShape, sizes, names, model_axis: int,
              top: int = 15) -> dict:
    """One step of ``run`` at ``shape`` on meta tensors, as rank 0 of a
    ``fake`` group over the mesh ``sizes``/``names`` × ``model_axis``:
    the recorder's and the tracker's measurements.  Call it in a process
    of its own (:func:`run_in_process`): it owns the process group for
    its duration."""
    from repro_torch.analysis.collectives import CommRecorder, summarize
    from repro_torch.analysis.run import fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import (build_serve, build_train,
                                            per_worker)
    world = int(math.prod(sizes)) * int(model_axis)
    out = {}
    with fake_group(world):
        t0 = time.perf_counter()
        mesh = make_mesh(sizes, names, device=torch.device("meta"),
                         model_axis=model_axis)
        if shape.kind == "train":
            pack = build_train(run, mesh, model_cfg=mcfg)
            p = pack.opt.config.p
            specs = train_batch_specs(mcfg, shape, pack.layout.n_workers)
            one = _meta_like(pack.worker_batch(specs))
            batches = {k: torch.empty((p,) + tuple(v.shape), dtype=v.dtype,
                                      device="meta") for k, v in one.items()}
            args = (pack.params_struct, pack.state_struct, batches)

            def call():
                return pack.train_round(*args, 0)
            out["bytes_per_comm_round"] = pack.opt.bytes_per_comm_round(
                per_worker(pack.params_struct))
            out["n_workers"] = pack.layout.n_workers
        else:
            sp = build_serve(run, mesh, shape, model_cfg=mcfg)
            if shape.kind == "prefill":
                batch = _meta_like({k: sp.local(v)
                                    for k, v in sp.pre_struct.items()})
                args = (sp.params_struct, batch)

                def call():
                    return sp.prefill_step(*args)
            else:
                rows = sp.rows.stop - sp.rows.start
                if mcfg.input_mode == "embeds":
                    tok = torch.empty((rows, 1, mcfg.d_model),
                                      dtype=getattr(torch,
                                                    mcfg.compute_dtype),
                                      device="meta")
                else:
                    tok = torch.empty((rows,), dtype=torch.int32,
                                      device="meta")
                args = (sp.params_struct, sp.cache_struct, tok)

                def call():
                    return sp.decode_step(*args, shape.seq_len - 1)
            out["n_workers"] = 1
        out["build_s"] = time.perf_counter() - t0
        live = LiveBytes()
        live.baseline(args)
        t0 = time.perf_counter()
        with CommRecorder(mesh) as rec, live, kernel_scopes(live):
            res = call()
        out["step_s"] = time.perf_counter() - t0
        stats = summarize(rec.calls)
        out["memory"] = {
            "argument_bytes": _storage_bytes(args),
            "output_bytes": _storage_bytes(res),
            "temp_bytes": live.peak,
            "alias_bytes": live.written_bytes(res)}
        out["collective_counts"] = stats.counts
        out["collective_result_bytes"] = stats.result_bytes
        out["collective_wire_bytes"] = stats.wire_bytes
        out["wire_bytes_per_device"] = stats.total_wire_bytes
        out["top_collectives"] = top_sites(rec.calls, top)
    return out


def top_sites(calls, top: int = 15) -> list:
    """The collectives grouped by op, site, group and payload, largest
    wire bytes × count first."""
    agg = {}
    for c in calls:
        key = (c.op, c.site, c.group, c.result_bytes, c.dtype,
               "×".join(c.axes), c.in_grad)
        n, w = agg.get(key, (0, 0.0))
        agg[key] = (n + 1, w + c.wire_bytes)
    rows = [{"op": k[0], "site": k[1], "group": k[2], "bytes": k[3],
             "dtype": k[4], "axes": k[5], "in_grad": k[6], "count": n,
             "wire_total": w} for k, (n, w) in agg.items()]
    rows.sort(key=lambda r: -r["wire_total"])
    return rows[:top]


def _child(fn, args, path):
    torch.set_num_threads(1)
    try:
        val = (True, fn(*args))
    except Exception:       # noqa: BLE001 - the parent raises it
        val = (False, traceback.format_exc())
    with open(path, "wb") as f:
        pickle.dump(val, f)


def run_in_process(fn, *args):
    """``fn(*args)`` in a spawned process of its own (``fn`` importable by
    name, the arguments picklable); its value, or a ``RuntimeError`` with
    the child's traceback."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="dryrun_") as d:
        path = os.path.join(d, "out.pkl")
        proc = mp.get_context("spawn").Process(target=_child,
                                               args=(fn, args, path))
        proc.start()
        proc.join()
        if not os.path.exists(path):
            raise RuntimeError(f"dry-run process exited {proc.exitcode} "
                               "with no result")
        with open(path, "rb") as f:
            ok, val = pickle.load(f)
    if not ok:
        raise RuntimeError(f"dry-run process failed:\n{val}")
    return val


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            overrides=None, tag: str = "") -> dict:
    """The record of ``arch`` × ``shape_name`` × the production mesh
    (``overrides(run)`` applied to the config), written to ``outdir``."""
    shape = SHAPES[shape_name]
    run = get_config(arch)
    if overrides:
        run = overrides(run)
    mcfg = run.model
    if shape_name == "long_500k":
        mcfg = long_ctx_variant(mcfg)
    if not shape_supported(mcfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True}
    fields = analytic_fields(run, mcfg, shape, multi_pod)
    sizes, names, tp = production_mesh(multi_pod)
    t0 = time.perf_counter()
    got = run_in_process(meta_step, run, mcfg, shape, sizes, names, tp)
    wall = time.perf_counter() - t0
    if got["n_workers"] != fields["n_workers"]:
        raise AssertionError(f"layout gives {got['n_workers']} workers, "
                             f"the analytic fields {fields['n_workers']}")
    terms = roofline_terms(fields["flops_per_device"],
                           fields["bytes_per_device"],
                           got["wire_bytes_per_device"])
    mem = got["memory"]
    record = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "tag": tag, **{k: fields[k] for k in (
            "kind", "n_chips", "n_workers", "profile", "optimizer", "p")},
        "build_s": round(got["build_s"], 1),
        "step_s": round(got["step_s"], 1),
        "wall_s": round(wall, 1),
        "tokens_per_call": fields["tokens_per_call"],
        "flops_per_device": fields["flops_per_device"],
        "bytes_per_device": fields["bytes_per_device"],
        "collective_counts": got["collective_counts"],
        "collective_result_bytes": got["collective_result_bytes"],
        "collective_wire_bytes": got["collective_wire_bytes"],
        "wire_bytes_per_device": got["wire_bytes_per_device"],
        "terms": terms,
        "model_flops": fields["model_flops"],
        "hlo_total_flops": fields["hlo_total_flops"],
        "useful_flops_ratio": fields["useful_flops_ratio"],
        "memory": mem,
        "peak_bytes": mem["argument_bytes"] + mem["temp_bytes"],
        "top_collectives": got["top_collectives"],
        "skipped": False,
    }
    if "bytes_per_comm_round" in got:
        record["bytes_per_comm_round"] = got["bytes_per_comm_round"]
    print(f"--- {arch} × {shape_name} × {record['mesh']} {tag}")
    print(f"terms: compute={terms['compute_s']*1e3:.2f}ms "
          f"memory={terms['memory_s']*1e3:.2f}ms "
          f"collective={terms['collective_s']*1e3:.2f}ms "
          f"dominant={terms['dominant']} "
          f"useful_ratio={record['useful_flops_ratio']:.2f} "
          f"peak/rank={record['peak_bytes']/2**30:.2f}GiB "
          f"build={got['build_s']:.1f}s step={got['step_s']:.1f}s "
          f"wall={wall:.1f}s")
    os.makedirs(outdir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{record['mesh']}"
    if tag:
        fname += f"__{tag}"
    with open(os.path.join(outdir, fname + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def hier_overrides(multi_pod: bool):
    """Two-level gossip on the production meshes: 16 workers → 4 nodes of
    4 on the single-pod worker axis; on the 2×16×16 mesh the node is the
    data axis (node_size 16, the pod boundary the node boundary)."""
    node_size = 16 if multi_pod else 4

    def ov(run):
        return dataclasses.replace(
            run, parallel=dataclasses.replace(run.parallel,
                                              node_size=node_size))
    return ov


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--hier", action="store_true",
                    help="the two-level gossip round (node_size 4 "
                         "single-pod / 16 multi-pod); records tagged __hier")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    t0 = time.perf_counter()
    for mp in meshes:
        for arch in archs:
            for shp in shapes:
                fname = f"{arch}__{shp}__{_mesh_name(mp)}"
                if args.hier:
                    fname += "__hier"
                path = os.path.join(args.outdir, fname + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"skip (exists): {fname}")
                    continue
                try:
                    run_one(arch, shp, mp, args.outdir,
                            overrides=(hier_overrides(mp) if args.hier
                                       else None),
                            tag=("hier" if args.hier else ""))
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shp, _mesh_name(mp),
                                     str(e).strip().splitlines()[-1][:200]))
    print(f"\nwall: {time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"\nFAILURES ({len(failures)}):")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nDRY-RUN: every combination ran one step on meta.")


if __name__ == "__main__":
    main()

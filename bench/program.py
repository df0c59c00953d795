"""The system under test: ``repro_torch``, built as a user builds it.

The only module of the benchmark that imports the program.  A cell's
configuration becomes a ``ModelCfg`` and ``make_model``; its traffic mix
an optimizer from ``make_optimizer(..., DenseComm(graph),
use_kernel=True)`` (the flatten-once kernel layout) and a ``SimTrainer``
over the model's loss.  What the benchmark takes from the program is
this object, its ``train`` call, and the parameter shapes it declares;
in a traced window it puts the optimizer's exchange inside spans of its
own (:meth:`Program.exchange_spans`), so that the trace can tell the
exchange's products from the gradient's, and reads the program's counters
on either side of the window (:meth:`Program.counters`).
"""
from __future__ import annotations

import contextlib
import sys

from bench.spec import ROOT


def _import_path():
    src = str(ROOT / "src")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise RuntimeError(f"the program is not in this checkout: no "
                           f"{ROOT / 'src' / 'repro_torch'}")
    if src not in sys.path:
        sys.path.insert(0, src)


class Program:
    def __init__(self, model: dict, traffic: dict, device):
        _import_path()
        from repro_torch.configs.base import LayerSpec, ModelCfg
        from repro_torch.core import (DenseComm, make_compressor,
                                      make_optimizer, make_topology)
        from repro_torch.models import make_model
        from repro_torch.train.trainer import SimTrainer
        fields = dict(model, pattern=tuple(LayerSpec(**p)
                                           for p in model["pattern"]))
        self.model = make_model(ModelCfg(**fields))
        graph = make_topology(traffic["topology"], (traffic["workers"],))
        comp = traffic.get("compressor")
        self.opt = make_optimizer(
            traffic["optimizer"], DenseComm(graph, device=device),
            eta=traffic["eta"], mu=traffic["mu"], p=traffic["p"],
            weight_decay=traffic["weight_decay"],
            gamma=traffic.get("gamma", 0.4),
            compressor=make_compressor(comp) if comp else None,
            use_kernel=True)
        self.trainer = SimTrainer(self.model.loss, self.opt, device=device)
        self.self_weight = self.opt.comm.self_weight()

    def param_shapes(self) -> dict:
        return dict(self.model.param_shapes())

    @contextlib.contextmanager
    def exchange_spans(self, name: str):
        """Within: the optimizer's exchange on the kernel layout
        (``comm_round_mat``, at each round's end) runs inside a
        ``record_function`` span ``name``; set on this optimizer object
        alone and taken off after."""
        from torch.profiler import record_function
        exchange = self.opt.comm_round_mat

        def spanned(*args, **kwargs):
            with record_function(name):
                return exchange(*args, **kwargs)
        self.opt.comm_round_mat = spanned
        try:
            yield
        finally:
            del self.opt.comm_round_mat

    def counters(self) -> dict:
        """The program's counters by name, as they stand: the port's
        ``repro_torch.spans.counters()`` where it has one; else each kernel
        wrapper's launches under the wrapper's name, as
        ``analysis.round_check.kernel_launches`` lists them, and the
        momentum launch's ``momentum_update.leaf_reads`` and
        ``momentum_update.leaf_copies``; ``{}`` where the port has
        neither."""
        try:
            from repro_torch import spans
            if hasattr(spans, "counters"):
                return dict(spans.counters())
            from repro_torch.analysis.round_check import kernel_launches
            from repro_torch.kernels.momentum import momentum_update
        except ImportError:
            return {}
        out = dict(kernel_launches())
        for k in ("leaf_reads", "leaf_copies"):
            out[f"momentum_update.{k}"] = getattr(momentum_update, k)
        return out

    def train(self, params, batch_fn, steps: int, **kw):
        """``SimTrainer.train``: ``(params, state, history)``."""
        return self.trainer.train(params, batch_fn, steps, **kw)

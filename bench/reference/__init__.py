"""The plain reference the benchmark judges the program by.

Plain PyTorch in f32, written from the published descriptions, frozen
here: no kernel, no cache, no batching over workers.  It imports nothing
of the program (``repro_torch``), of JAX or of the JAX package.  Each
model module gives ``param_shapes(model)``, ``init_rule(name, shape)``
and ``loss(params, batch, model, ops)`` for one worker; each round module
(``pd_sgdm``, ``cpd_sgdm_sign``) gives ``Round``, which follows the
optimizer's first round from x0, worker by worker and leaf by leaf.
"""

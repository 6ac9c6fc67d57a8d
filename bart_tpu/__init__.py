"""bart_tpu — Bayesian Atmospheric Radiative Transfer in JAX.

A from-scratch JAX/XLA/Pallas framework, run on the GPU, with the capabilities of the
reference exosports/BART pipeline (Bayesian exoplanet-atmosphere
retrieval): line-by-line radiative transfer, DEMC/snooker MCMC with all
chains vmapped on-device, and wavenumber-sharded multi-chip execution.

Public API entry points (lazily imported):

    bart_tpu.ForwardModel / ForwardConfig   the forward model
    bart_tpu.Likelihood / ParamSpace        likelihood wiring
    bart_tpu.run_mcmc                       the retrieval
    bart_tpu.Pipeline / load_config         the staged CLI pipeline
    bart_tpu.make_mesh / shard_model        multi-chip sharding
"""

__version__ = "0.1.0"

_LAZY = {
    "ForwardModel": ("bart_tpu.rt.forward", "ForwardModel"),
    "ForwardConfig": ("bart_tpu.rt.forward", "ForwardConfig"),
    "Likelihood": ("bart_tpu.inference.likelihood", "Likelihood"),
    "ParamSpace": ("bart_tpu.inference.likelihood", "ParamSpace"),
    "run_mcmc": ("bart_tpu.inference.retrieval", "run_mcmc"),
    "EnsembleSampler": ("bart_tpu.inference.samplers", "EnsembleSampler"),
    "Pipeline": ("bart_tpu.driver.pipeline", "Pipeline"),
    "load_config": ("bart_tpu.driver.config", "load_config"),
    "make_mesh": ("bart_tpu.parallel.mesh", "make_mesh"),
    "shard_model": ("bart_tpu.parallel.mesh", "shard_model"),
    "build_opacity_grid": ("bart_tpu.opacity.grid", "build_opacity_grid"),
    "load_tli": ("bart_tpu.linelist.tli", "load_tli"),
    "save_tli": ("bart_tpu.linelist.tli", "save_tli"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'bart_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))

"""Worker for the multi-host smoke test (test_parallel.py).

Launched as N separate OS processes that form one JAX process group
over the jax.distributed coordination service — the accelerator-side
replacement for the reference's mpiexec/MPICH world (reference:
BART.py:576-580; bart_tpu/parallel/distributed.py).  Each process
contributes 4 virtual CPU devices; the global (chain,) mesh spans all
N*4 devices and one sharded MCMC block runs across them.

Usage: python distributed_worker.py <coordinator> <nproc> <pid> <out>
"""

import os
import sys

# Launched by absolute script path, so sys.path[0] is tests/ — add the
# repo root so bart_tpu imports regardless of the parent's cwd/env.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

coordinator, nproc, pid, out = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8 // nproc)  # 8 global devices
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from bart_tpu.parallel.distributed import init_distributed, is_multihost  # noqa: E402

if nproc > 1:
    multi = init_distributed(coordinator, nproc, pid)
    assert multi
    assert jax.process_count() == nproc
assert len(jax.devices()) == 8
assert is_multihost() == (nproc > 1)

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from bart_tpu.inference.likelihood import Likelihood, ParamSpace  # noqa: E402
from bart_tpu.inference.samplers import EnsembleSampler  # noqa: E402
from bart_tpu.parallel.mesh import make_mesh  # noqa: E402

mesh = make_mesh(n_chain=8, n_wn=1, devices=jax.devices())


def forward(p):
    model = jnp.stack([p[0] + p[1], p[0] - p[1], p[0] * p[1]])
    return model, model, jnp.asarray(True)


space = ParamSpace([0.5, -0.2], [-5, -5], [5, 5], [0.1, 0.1])
like = Likelihood(forward, space, np.array([1.2, 0.4, -0.3]),
                  np.array([0.05, 0.05, 0.05]))
sampler = EnsembleSampler(
    loglike_fn=like, nfree=2, nmodel=3, nchains=16, walk="snooker",
    pmin=space.free_min, pmax=space.free_max,
    stepsize=space.stepsize[space.ifree],
)
key = jax.random.key(7)
state = sampler.init_state(key, dtype=jnp.float64)
chain_sh = NamedSharding(mesh, P("chain"))
rep = NamedSharding(mesh, P())
state = state._replace(
    positions=jax.device_put(np.asarray(state.positions), chain_sh),
    loglike=jax.device_put(np.asarray(state.loglike), chain_sh),
    models=jax.device_put(np.asarray(state.models), chain_sh),
    z_archive=jax.device_put(np.asarray(state.z_archive), rep),
)

state, pb, lb, mb = sampler.run_block(state, key, 4)


@jax.jit
def summarize(pb, lb):
    # reductions over the sharded chain axis -> replicated scalars
    return jnp.stack([
        jnp.sum(lb), jnp.sum(lb * lb), jnp.sum(pb), jnp.sum(pb * pb),
    ])


stats = np.asarray(summarize(pb, lb))
assert np.all(np.isfinite(stats)), stats
if pid == 0:
    np.save(out, stats)
    print(f"distributed_worker: {nproc} processes x {8 // nproc} devices "
          f"OK, stats={stats}")

"""Sharded execution tests on the 8-virtual-device CPU mesh."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bart_tpu.parallel.mesh import make_mesh, shard_model, table_shardings
from test_rt import DEMO_PARAMS, make_demo_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fm():
    return make_demo_forward("eclipse")


def test_mesh_construction():
    mesh = make_mesh(n_chain=2, n_wn=4)
    assert mesh.shape == {"chain": 2, "wn": 4}
    mesh1 = make_mesh(n_chain=1, n_wn=8)
    assert mesh1.shape == {"chain": 1, "wn": 8}


def test_sharded_forward_matches_unsharded(fm):
    p = jnp.asarray(DEMO_PARAMS)
    ref_bf, ref_spec, ref_valid = fm.jitted()(p)
    ref_bf, ref_spec = np.asarray(ref_bf), np.asarray(ref_spec)

    mesh = make_mesh(n_chain=1, n_wn=8)
    shard_model(fm, mesh)
    bf, spec, valid = fm.jitted()(p)
    assert bool(valid)
    # wn-sharded execution must be numerically identical (deterministic
    # reductions; the 'bitwise-stable posterior' target); the spectrum
    # carries trailing pad samples after sharding
    np.testing.assert_allclose(np.asarray(bf), ref_bf, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(spec)[: fm.n_wn_orig], ref_spec, rtol=1e-12
    )

    # tables actually live sharded on the mesh:
    sh = fm.tables["sigma"].sharding
    assert isinstance(sh, NamedSharding)
    assert sh.spec == P(None, None, None, "wn")


def test_sharded_batched_chains(fm):
    mesh = make_mesh(n_chain=2, n_wn=4)
    shard_model(fm, mesh)
    batch = jnp.asarray(np.tile(DEMO_PARAMS, (8, 1)))
    batch = jax.device_put(batch, NamedSharding(mesh, P("chain", None)))
    bf, spec, valid = fm.batched()(batch)
    assert bool(jnp.all(valid))
    np.testing.assert_allclose(
        np.asarray(bf), np.broadcast_to(np.asarray(bf)[0], bf.shape),
        rtol=1e-12,
    )


@pytest.mark.slow
def test_sharded_mcmc_block(fm):
    """Full snooker MCMC block over the mesh (the dryrun in pytest)."""
    from bart_tpu.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu.inference.samplers import EnsembleSampler

    mesh = make_mesh(n_chain=2, n_wn=4)
    shard_model(fm, mesh)
    truth = DEMO_PARAMS
    data = np.asarray(fm.jitted()(jnp.asarray(truth))[0])
    space = ParamSpace(
        pinit=truth, pmin=[-5, -2, -2, 0, 0.55, -9],
        pmax=[-1, 1, 1, 1, 1.2, 1.5],
        stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1],
    )
    like = Likelihood(fm, space, data, 0.03 * data)
    sampler = EnsembleSampler(
        loglike_fn=like, nfree=space.nfree, nmodel=len(data), nchains=8,
        walk="snooker", pmin=space.free_min, pmax=space.free_max,
        stepsize=space.stepsize[space.ifree],
    )
    key = jax.random.key(0)
    state = sampler.init_state(key, dtype=jnp.float64)
    chain_sh = NamedSharding(mesh, P("chain"))
    state = state._replace(
        positions=jax.device_put(state.positions, chain_sh),
        loglike=jax.device_put(state.loglike, chain_sh),
        models=jax.device_put(state.models, chain_sh),
    )
    state, pb, lb, mb = sampler.run_block(state, key, 3)
    lb = np.asarray(lb)
    assert lb.shape == (3, 8)
    assert np.all(np.isfinite(lb))

    # determinism across mesh layouts: same seed on a 1x8 mesh
    fm2 = make_demo_forward("eclipse")
    mesh2 = make_mesh(n_chain=1, n_wn=8)
    shard_model(fm2, mesh2)
    like2 = Likelihood(fm2, space, data, 0.03 * data)
    sampler2 = EnsembleSampler(
        loglike_fn=like2, nfree=space.nfree, nmodel=len(data), nchains=8,
        walk="snooker", pmin=space.free_min, pmax=space.free_max,
        stepsize=space.stepsize[space.ifree],
    )
    state2 = sampler2.init_state(jax.random.key(0), dtype=jnp.float64)
    state2, pb2, lb2, mb2 = sampler2.run_block(state2, jax.random.key(0), 3)
    np.testing.assert_allclose(np.asarray(lb2), lb, rtol=1e-12)


def test_sharded_on_the_fly_matches_unsharded():
    """Table-free (line-tiles) mode under the wn mesh: bucketed wings
    ARE the halo, so sharded results must match unsharded exactly."""
    from test_rt import DEMO, DEMO_PARAMS, DEMO_TEP
    from bart_tpu.io.filters import read_filter
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.tep import PlanetSystem
    from bart_tpu.linelist.tli import synthetic_linelist
    from bart_tpu.obs.bands import build_band_matrix
    from bart_tpu.opacity.extinction import tile_lines, wing_cutoff, BroadeningSpec
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.utils.grids import pressure_grid
    from bart_tpu import constants as const
    from bart_tpu.linelist.molecules import get_molecule

    system = PlanetSystem.from_tep(DEMO_TEP)
    pressure = pressure_grid(20, 1e-5, 100.0)
    wn = np.arange(2500.0, 5001.0, 10.0)   # 251 points: pads to 8 shards
    species = ["H2", "He", "CH4"]
    base_q = np.tile([0.85, 0.149, 1e-3], (20, 1))
    ll = synthetic_linelist("CH4", 2500.0, 5000.0, 300, seed=7)

    mol = get_molecule("CH4")
    spec = BroadeningSpec()
    cutoff = wing_cutoff(20.0, 5000.0, 400.0, 100.0 * const.BAR_TO_BARYE,
                         mol.mass * const.AMU, mol.diameter * 1e-8, spec)
    tiles = tile_lines(ll, wn, cutoff, tile_size=64)

    starfl, _ = blackbody_star(wn, system.t_star)
    filters = [read_filter(f"{DEMO}/fdemo{i:02d}.dat")
               for i in range(1, 11)]
    bands = build_band_matrix(wn, filters, star_flux=starfl,
                              rprs=system.rprs)

    def build():
        return ForwardModel(
            ForwardConfig(solution="eclipse", pt_type="line",
                          molfit=("CH4",)),
            wn_grid=wn, pressure=pressure, species=species,
            base_abundances=base_q, opacity={"CH4": tiles}, system=system,
            bands=bands, nwidth=20.0, dtype=jnp.float64,
        )

    p = jnp.asarray(DEMO_PARAMS)
    fm_ref = build()
    ref_bf, ref_spec, ref_valid = fm_ref.jitted()(p)
    assert bool(ref_valid)

    fm_sh = build()
    mesh = make_mesh(n_chain=1, n_wn=8)
    shard_model(fm_sh, mesh)
    # tile arrays are sharded along the wn mesh axis
    assert fm_sh.tables["lt0_wn0"].sharding.spec == P("wn", None)
    bf, spec_out, valid = fm_sh.jitted()(p)
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(bf), np.asarray(ref_bf),
                               rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(spec_out)[: fm_sh.n_wn_orig], np.asarray(ref_spec),
        rtol=1e-12,
    )


@pytest.mark.slow
def test_multihost_two_process_smoke(tmp_path):
    """Two real OS processes form a jax.distributed group (localhost
    coordinator over the DCN path the reference covers with mpiexec,
    BART.py:576-580), run one sharded MCMC block over the global
    16-chain mesh, and match the single-process result."""
    import socket
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")

    def free_port():
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)

    def run(nproc, out):
        coord = f"localhost:{free_port()}"
        procs = [
            subprocess.Popen(
                [sys.executable, worker, coord, str(nproc), str(pid), out],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for pid in range(nproc)
        ]
        logs = [p.communicate(timeout=420)[0].decode() for p in procs]
        for p, lg in zip(procs, logs):
            assert p.returncode == 0, lg
        return logs

    out2 = str(tmp_path / "stats2.npy")
    logs = run(2, out2)
    assert any("2 processes x 4 devices OK" in lg for lg in logs), logs

    # single-process reference on the same 8-device problem
    out1 = str(tmp_path / "stats1.npy")
    run(1, out1)

    s1, s2 = np.load(out1), np.load(out2)
    np.testing.assert_allclose(s2, s1, rtol=1e-9)


def test_sharded_folded_matches_unsharded():
    """Folded-rtosamp tables (sigmak/frowsk) shard along the output-wn
    axis and reproduce unsharded results exactly; the adaptive split
    is rejected with a pointer to rtadapt=False."""
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.tep import PlanetSystem
    from bart_tpu.linelist.tli import synthetic_linelist
    from bart_tpu.obs.bands import build_band_matrix
    from bart_tpu.opacity.grid import build_opacity_grid
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.utils.grids import (
        folded_fine_grid, pressure_grid, wavenumber_grid,
    )

    K = 4
    pressure = pressure_grid(14, 1e-5, 100.0)
    wn_out = wavenumber_grid(wnlow=2500.0, wnhigh=2549.0, wndelt=1.0)
    wn_fine = folded_fine_grid(wn_out, K)
    system = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
    lines = synthetic_linelist("CH4", 2480.0, 2570.0, 150, seed=5)
    grid = build_opacity_grid(
        {"CH4": lines}, wn_fine, np.arange(400.0, 3001.0, 650.0),
        pressure, dtype=jnp.float64,
    )
    filters = [(np.linspace(c - 5, c + 5, 21), np.ones(21))
               for c in (2510.0, 2525.0, 2540.0)]
    sf, _ = blackbody_star(wn_out, system.t_star)
    bands = build_band_matrix(wn_out, filters, star_flux=sf,
                              rprs=system.rprs)
    kw = dict(
        wn_grid=wn_out, pressure=pressure, species=["H2", "He", "CH4"],
        base_abundances=np.tile([0.85, 0.149, 1e-3], (14, 1)),
        opacity=grid, system=system, bands=bands, dtype=jnp.float64,
    )
    cfg = ForwardConfig(solution="eclipse", pt_type="line",
                        molfit=("CH4",))
    fm = ForwardModel(cfg, fold_osamp=K, fold_adapt=None, **kw)
    p = jnp.asarray(DEMO_PARAMS, fm.dtype)
    ref_bf, ref_spec, _ = fm.jitted()(p)

    mesh = make_mesh(n_chain=1, n_wn=8)
    shard_model(fm, mesh)
    bf, spec, valid = fm.jitted()(p)
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(bf), np.asarray(ref_bf),
                               rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(spec)[: fm.n_wn_orig], np.asarray(ref_spec),
        rtol=1e-12)
    sh = fm.tables["sigmak"].sharding
    assert isinstance(sh, NamedSharding)
    assert sh.spec == P(None, None, None, "wn")

    # adaptive split cannot shard contiguously -> explicit error
    fm_ad = ForwardModel(cfg, fold_osamp=K, fold_adapt=0.02, **kw)
    if fm_ad._idx_fine is not None:
        with pytest.raises(ValueError, match="rtadapt"):
            shard_model(fm_ad, mesh)

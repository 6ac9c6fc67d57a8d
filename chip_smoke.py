#!/usr/bin/env python
"""Smoke test of the retrieval on the GPU.

    python chip_smoke.py           # one GPU: phases 1-5
    python chip_smoke.py --multi   # four GPUs: the (chain, wn) mesh only

Phases (each fails loudly: any failure is a non-zero exit):

1. device: a GPU must be present; prints the card's name and power
   limit (nvidia-smi), the JAX device kind and version;
2. main path: the CLI (``bart_tpu.driver.cli.main``, in this process)
   on examples/demo_eclipse.cfg and examples/demo_transit.cfg at their
   own width (100 layers, 2501 bins, 30k lines, 27 T nodes, 8 chains),
   overriding only numit, plots and loc_dir;
3. K=1 parity: the bench problem's 512-chain ``fm.batched()`` (eclipse
   raygrid and expsum, transit) against the plain per-sample model in
   float64 on the CPU, on a chain subset;
4. folded rtosamp=32 (fold_adapt 0.02, bf16 fine tables; eclipse
   expsum, transit raygrid) at 512 chains against the float64
   fine-grid model on the CPU, on a chain subset; peak device memory;
5. timings for the record: ms per serialized 512-chain batch.

``--multi`` runs only the mesh path of bart_tpu/parallel/mesh.py on a
2x2 (chain, wn) mesh: one MCMC block, the demo-width sharding check,
and the sharded forward against the single-card forward.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, ".smoke_out")
# the bench problem: demo width (100 layers, 2501 bins, 30k lines)
BENCH = dict(nlayer=100, nwave=2501, nlines=30000, cache=True)
NCHAIN = 512
NSUB = 16           # chains compared against the float64 reference
NSUB_FOLD = 4
# f32 forward against the f64 reference (the interpret-mode kernel
# test's bound, tests/test_fused.py)
TOL_K1 = 5e-5
# folded, bf16-stored fine tables against the f64 fine-grid model on
# the f32 table: the bf16 storage bounds of
# tests/test_fused.py::test_forward_model_fold_bf16_tables
TOL_FOLD_BAND = 2e-3
TOL_FOLD_SPEC = 3e-2
DEMO_PARAMS = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def check(name, err, bound):
    print(f"   {name}: max rel err {err:.3e} (bound {bound:.0e})",
          flush=True)
    if not err <= bound:
        raise AssertionError(f"{name}: {err:.3e} > {bound:.0e}")


def device_phase(count):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"jax {jax.__version__}: {devs[0].device_kind} x {len(devs)}",
          flush=True)
    return devs


def peak_gib(dev):
    """Peak device memory of this process so far [GiB]."""
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30


def time_batch(fb, params, nrep=20, rounds=3):
    """ms per batch, serialized: each step's input depends on the last
    step's output, and the round ends in a host read."""
    import jax.numpy as jnp

    out = fb(params)
    times = []
    for _ in range(rounds):
        p = params
        t0 = time.perf_counter()
        for _ in range(nrep):
            out = fb(p)
            p = params + 0.0 * jnp.sum(out[0])
        float(jnp.sum(out[0]))
        times.append((time.perf_counter() - t0) / nrep)
    return 1e3 * min(times)


def chain_params(fm, n, seed=0):
    """n perturbed demo parameter vectors (a fitted radius for transit)."""
    import jax.numpy as jnp

    p = np.tile(DEMO_PARAMS, (n, 1)) + np.random.default_rng(seed).normal(
        0.0, 0.005, (n, 6))
    if fm.config.solution == "transit":
        p = np.concatenate([p[:, :5], np.full((n, 1), fm.r0_km), p[:, 5:]],
                           axis=1)
    return jnp.asarray(p, fm.dtype)


def reference_f64(fm, params, *, wn=None):
    """The plain per-sample model in float64 on the CPU (lax.map: no
    vmap, hence no kernel), built from host copies of ``fm``'s inputs;
    ``wn`` the grid of ``fm.opacity`` when that is not ``fm.wn``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bart_tpu.obs.bands import BandMatrix, build_band_matrix
    from bart_tpu.rt.forward import ForwardModel

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        if wn is None:
            wn = np.asarray(fm.wn, np.float64)
            bands = BandMatrix(jnp.asarray(np.asarray(
                fm.bands.weights, np.float64)), fm.bands.nfilters)
        else:
            # spectra only: one band over the whole grid
            bands = build_band_matrix(wn, [(wn[1:-1], np.ones(len(wn) - 2))])
        sigma = np.asarray(fm.opacity.sigma, np.float64)
        ref = ForwardModel(
            fm.config, wn_grid=wn,
            pressure=np.asarray(fm.pressure, np.float64),
            species=fm.species,
            base_abundances=np.asarray(fm.tables["base_q"], np.float64),
            opacity=dataclasses.replace(fm.opacity, sigma=sigma),
            system=fm.system, bands=bands, dtype=jnp.float64)
        p = jax.device_put(np.asarray(params, np.float64), cpu)
        band, spec, valid = jax.jit(
            lambda q: jax.lax.map(ref.__call__, q))(p)
        assert bool(np.all(np.asarray(valid)))
        return np.asarray(band), np.asarray(spec)


def cli_phase(cfg_name, numit):
    from bart_tpu.driver.cli import main
    from bart_tpu.opacity.grid import load_grid

    loc = os.path.join(OUT, cfg_name)
    shutil.rmtree(loc, ignore_errors=True)
    rc = main(["-c", os.path.join(REPO, "examples", f"{cfg_name}.cfg"),
               "--numit", str(numit), "--plots", "False", "--loc_dir", loc])
    assert rc == 0, rc
    post = np.load(os.path.join(loc, "output.npy"))
    assert post.size and np.all(np.isfinite(post)), post.shape
    with open(os.path.join(loc, "MCMC.log")) as f:
        accept = float(re.findall(r"accept=([0-9.]+)", f.read())[-1])
    assert 0.0 < accept < 1.0, accept
    grid = load_grid(os.path.join(loc, "opacity_CH4.npz"))
    assert tuple(grid.sigma.shape) == (1, 27, 100, 2501), grid.sigma.shape
    print(f"   {cfg_name}: posterior {post.shape} finite, acceptance "
          f"{accept:.3f}, opacity table {tuple(grid.sigma.shape)}")
    with open(os.path.join(loc, "stage_timing.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            print(f"   {cfg_name} stage {rec['stage']}: {rec['wall_s']} s")


def k1_phase(timings):
    import jax.numpy as jnp

    import __graft_entry__ as ge
    import bart_tpu.rt.fused as fused

    for solution, quad in (("eclipse", "raygrid"), ("eclipse", "expsum"),
                           ("transit", "raygrid")):
        name = f"{solution} K=1 {quad}"
        t0 = time.perf_counter()
        fm = ge._build_problem(solution=solution, quadrature=quad, **BENCH)
        t_build = time.perf_counter() - t0
        params = chain_params(fm, NCHAIN)
        t0 = time.perf_counter()
        band, spec, valid = fm.batched()(params)
        assert bool(jnp.all(valid))
        print(f"   {name}: table {t_build:.1f} s, compile + first batch "
              f"{time.perf_counter() - t0:.1f} s, spectrum "
              f"{tuple(spec.shape)}")
        band_r, spec_r = reference_f64(fm, params[:NSUB])
        check(f"{name} band flux vs f64", rel_err(band[:NSUB], band_r),
              TOL_K1)
        check(f"{name} spectrum vs f64", rel_err(spec[:NSUB], spec_r),
              TOL_K1)
        timings[name] = time_batch(fm.batched(), params)
        if solution == "eclipse":
            # the plain path XLA compiles, for the kernel-vs-plain record
            real = fused.use_kernel
            fused.use_kernel = lambda backend=None: False
            try:
                timings[f"{name} plain"] = time_batch(fm.batched(), params)
            finally:
                fused.use_kernel = real


def fold_phase(timings, dev):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from bart_tpu.obs.bands import band_integrate
    from bart_tpu.utils.grids import folded_fine_grid

    K = 32
    for solution, quad in (("eclipse", "expsum"), ("transit", "raygrid")):
        name = f"{solution} K=32 {quad}"
        t0 = time.perf_counter()
        fm = ge._build_problem(solution=solution, quadrature=quad, fold=K,
                               fold_adapt=0.02, fold_bf16=True, **BENCH)
        t_build = time.perf_counter() - t0
        frac = (len(fm._idx_fine) / fm.wn.shape[0] if fm._idx_fine is not None
                else 1.0)
        params = chain_params(fm, NCHAIN)
        fb = jax.jit(jax.vmap(fm.__call__, in_axes=(0, None)))
        compiled = fb.lower(params, fm.tables).compile()
        mem = compiled.memory_analysis()
        t0 = time.perf_counter()
        band, spec, valid = compiled(params, fm.tables)
        assert bool(jnp.all(valid))
        print(f"   {name}: table build {t_build:.1f} s (fine fraction "
              f"{frac:.3f}), compile + first batch "
              f"{time.perf_counter() - t0:.1f} s, temp "
              f"{mem.temp_size_in_bytes / 2**30:.2f} GiB, peak device "
              f"memory {peak_gib(dev):.2f} GiB", flush=True)
        # f64 fine-grid truth: the plain K=1 model on the fine grid with
        # the spectrum averaged per bin (f32 table: the error includes
        # the bf16 table storage)
        wn_fine = folded_fine_grid(np.asarray(fm.wn, np.float64), K)
        _, spec_f = reference_f64(fm, params[:NSUB_FOLD], wn=wn_fine)
        spec_r = spec_f.reshape(NSUB_FOLD, -1, K).mean(axis=-1)
        band_r = np.stack([np.asarray(band_integrate(
            np.asarray(fm.tables["band_w"], np.float64), s))
            for s in spec_r])
        check(f"{name} band flux vs f64 fine grid",
              rel_err(band[:NSUB_FOLD], band_r), TOL_FOLD_BAND)
        check(f"{name} spectrum vs f64 fine grid",
              rel_err(spec[:NSUB_FOLD], spec_r), TOL_FOLD_SPEC)
        timings[name] = time_batch(fm.batched(), params, nrep=5)
        del fm, compiled


def multi_phase():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from bart_tpu.parallel.mesh import make_mesh, shard_model

    mesh = make_mesh(n_chain=2, n_wn=2, devices=jax.devices()[:4])
    with phase("mesh: one MCMC block and the demo-width sharding check"):
        ge.dryrun_multichip(4)
    with phase("mesh: sharded forward vs single-card forward"):
        for solution in ("eclipse", "transit"):
            fm = ge._build_problem(solution=solution, **BENCH)
            params = chain_params(fm, 64)
            band1, spec1, _ = fm.batched()(params)
            band1, spec1 = np.asarray(band1), np.asarray(spec1)
            shard_model(fm, mesh)
            ps = jax.device_put(params, NamedSharding(mesh, P("chain")))
            f = jax.jit(jax.vmap(fm.__call__, in_axes=(0, None)))
            band4, spec4, _ = f(ps, fm.tables)
            check(f"{solution} sharded band flux",
                  rel_err(band4, band1), 1e-5)
            check(f"{solution} sharded spectrum",
                  rel_err(np.asarray(spec4)[:, :spec1.shape[1]], spec1),
                  1e-5)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU (chain, wn) mesh path")
    ap.add_argument("--numit", type=int, default=6400,
                    help="CLI retrieval samples (8 chains: 8 blocks)")
    args = ap.parse_args()
    count = 4 if args.multi else 1

    with phase("device"):
        devs = device_phase(count)
    sys.path.insert(0, REPO)
    from bart_tpu.utils.compile_cache import enable_compile_cache

    print(f"   compile cache: {enable_compile_cache()}")
    os.makedirs(OUT, exist_ok=True)

    if args.multi:
        multi_phase()
    else:
        with phase("main path: demo eclipse retrieval through the CLI"):
            cli_phase("demo_eclipse", args.numit)
        with phase("main path: demo transit retrieval through the CLI"):
            cli_phase("demo_transit", args.numit)
        timings = {}
        with phase("K=1 parity at 512 chains"):
            k1_phase(timings)
        with phase("folded rtosamp=32 at 512 chains"):
            fold_phase(timings, devs[0])
        with phase("timings (ms per serialized 512-chain batch)"):
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
            for name, ms in timings.items():
                print(f"   {name}: {ms:.3f} ms [{smi}]")

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()

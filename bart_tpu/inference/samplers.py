"""MCMC walkers: snooker / DEMC / MRW / uniform sweep, fully on-device.

Accelerator-side inversion of MC3's process model (reference: SURVEY.md
sections 2.3/3.2): where the reference runs one MPI process per chain
with a scatter/gather per iteration, bart_tpu advances the entire
chain ensemble inside a single jitted ``lax.scan`` — zero host
round-trips per step, thousands of chains per chip.

Walkers (the reference's ``walk`` options, code/BART.py:188-191):

* ``mrw``     Metropolis random walk, Gaussian proposals scaled by
              ``stepsize``.
* ``demc``    ter Braak (2006) DE-MC: x' = x + gamma (x_r1 - x_r2) + e,
              gamma = 2.38/sqrt(2 nfree), with 10% gamma=1 full jumps.
* ``snooker`` ter Braak & Vrugt (2008) DE-MC(Z) with snooker updates:
              proposals from a thinned past archive Z; 90% parallel
              direction moves, 10% snooker moves along (x - z) with the
              |x'-z|^{d-1}/|x-z|^{d-1} Metropolis correction.
* ``unif``    uniform prior sweep (no MH accept; the reference
              synthesizes dummy data for this mode,
              code/makecfg.py:178-190).

All randomness uses explicit JAX PRNG keys — bitwise-reproducible
posteriors for a fixed seed, independent of host, chip count, or
iteration batching (the reference cannot replay a run at all).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["SamplerState", "EnsembleSampler"]


def _reflect(x, lo, hi):
    """Fold proposals into [lo, hi] by reflection at the boundaries.

    For a SYMMETRIC step kernel (MRW Gaussian, DE difference vectors)
    the reflection tiling of the interval preserves proposal symmetry
    q(y|x) = q(x|y), so Metropolis acceptance is unchanged — but
    proposals that would land outside the prior box (auto-rejected as
    loglike = -inf) are mapped to valid points instead.  On wide
    prior-plateau directions this is the difference between a few
    percent and a healthy acceptance rate: DE difference vectors span
    the full prior there, so a large fraction of raw proposals leave
    the box (measured on the WASP-12b regression: accept 0.046 without
    reflection, with every rejection wasting a full forward-model
    evaluation).
    """
    span = hi - lo
    y = jnp.mod(x - lo, 2.0 * span)
    y = jnp.where(y > span, 2.0 * span - y, y)
    return jnp.where(span > 0, lo + y, x)


class SamplerState(NamedTuple):
    """Device-resident ensemble state (a pytree; checkpointable)."""

    positions: jax.Array   # [nchain, nfree]
    loglike: jax.Array     # [nchain]
    models: jax.Array      # [nchain, nmodel] current band fluxes
    z_archive: jax.Array   # [nz, nfree] past states (snooker)
    z_count: jax.Array     # scalar int32: filled slots in z_archive
    best_pos: jax.Array    # [nfree]
    best_loglike: jax.Array
    naccept: jax.Array     # [nchain] int32
    niter: jax.Array       # scalar int32


@dataclasses.dataclass
class EnsembleSampler:
    """Vectorized multi-chain sampler over a jitted log-likelihood.

    ``loglike_fn(free[nfree]) -> (logl, model[nmodel])`` must be pure
    (it is vmapped over chains).
    """

    loglike_fn: Any
    nfree: int
    nmodel: int
    nchains: int
    walk: str = "snooker"
    pmin: np.ndarray | None = None     # [nfree] (used by unif + init)
    pmax: np.ndarray | None = None
    stepsize: np.ndarray | None = None # [nfree] MRW proposal sigmas
    nz: int = 0                        # archive size (0 -> 10*nfree*? auto)
    # archive append period: the round-5 WASP-12b sweep (examples/
    # sampler_sweep.py, 3 seeds) shows 30 beats 10 seedwise on BOTH
    # min bulk ESS (140/100/199 vs 125/64/103) and split-R-hat —
    # longer-range history decorrelates the DE difference vectors
    z_thin: int = 30
    snooker_frac: float = 0.1
    gamma_jump_frac: float = 0.1       # demc full-jump probability
    eps: float = 1e-6                  # demc jitter scale
    fgamma: float = 1.0                # scale on the DE gamma (MC3 fgamma)

    def __post_init__(self):
        if self.nz == 0:
            # the archive must hold real HISTORY: at 10*nchains it spans
            # >= 10 append epochs (z_thin iterations apart) — 2*nchains
            # (rounds 1-3) degenerated to the last two epochs at large
            # ensembles, collapsing snooker toward plain DEMC
            self.nz = max(10 * self.nfree, 10 * self.nchains, 100)
        self._run_block = None
        self._eval_jit = None

    def _eval(self, positions, tables):
        """vmapped loglike over the ensemble.  ``tables`` (the forward
        model's device-array pytree, when the likelihood exposes one)
        is threaded through as a traced ARGUMENT: a sharded pytree
        captured by closure would be embedded as replicated HLO
        constants, losing the multi-chip wn partitioning in the
        compiled hot loop (parallel/mesh.py design)."""
        if tables is None:
            return jax.vmap(self.loglike_fn)(positions)
        return jax.vmap(lambda p: self.loglike_fn(p, tables))(positions)

    @property
    def _tables(self):
        return getattr(self.loglike_fn, "tables", None)

    # ------------------------------------------------------------------
    def init_state(self, key, init_positions: np.ndarray | None = None,
                   dtype=jnp.float64) -> SamplerState:
        """Initial ensemble: given positions, or uniform in [pmin,pmax]."""
        kpos, kz = jax.random.split(key)
        lo = jnp.asarray(self.pmin, dtype)
        hi = jnp.asarray(self.pmax, dtype)
        if init_positions is None:
            pos = jax.random.uniform(
                kpos, (self.nchains, self.nfree), dtype, lo, hi
            )
        else:
            pos = jnp.asarray(init_positions, dtype)
        # JIT the initial ensemble evaluation: eager op-by-op dispatch
        # of the vmapped forward keeps every intermediate alive at once
        # (for a folded K=32 production table the dispatch-layer
        # transpose+pad transients alone are ~2x the 3.6 GB table —
        # a measured device-memory exhaustion before the retrieval
        # even started),
        # while under jit XLA plans and reuses that memory.
        if self._eval_jit is None:
            self._eval_jit = jax.jit(self._eval)
        logl, models = self._eval_jit(pos, self._tables)
        zinit = jax.random.uniform(kz, (self.nz, self.nfree), dtype, lo, hi)
        # Seed the archive with the initial population (fallback draws
        # uniform so snooker differences are defined from step one):
        ncopy = min(self.nchains, self.nz)
        zinit = zinit.at[:ncopy].set(pos[:ncopy])
        ibest = jnp.argmax(logl)
        return SamplerState(
            positions=pos,
            loglike=logl,
            models=models,
            z_archive=zinit,
            z_count=jnp.asarray(max(ncopy, 2), jnp.int32),
            best_pos=pos[ibest],
            best_loglike=logl[ibest],
            naccept=jnp.zeros(self.nchains, jnp.int32),
            niter=jnp.asarray(0, jnp.int32),
        )

    # ------------------------------------------------------------------
    def _propose(self, key, state: SamplerState, gamma_scale):
        """One synchronous ensemble proposal -> (xnew, log_mh_corr).

        ``gamma_scale`` scales the DE gamma (MC3's fgamma), passed as a
        traced scalar so the retrieval driver can adapt it during
        burn-in without recompiling the block."""
        n, d = self.nchains, self.nfree
        pos = state.positions
        dtype = pos.dtype
        lo = hi = None
        if self.pmin is not None and self.pmax is not None:
            lo = jnp.asarray(self.pmin, dtype)
            hi = jnp.asarray(self.pmax, dtype)

        def fold(x):
            return _reflect(x, lo, hi) if lo is not None else x

        if self.walk == "mrw":
            step = jnp.asarray(self.stepsize, dtype)
            noise = jax.random.normal(key, (n, d), dtype)
            return fold(pos + noise * step), jnp.zeros(n, dtype)

        if self.walk == "unif":
            lo = jnp.asarray(self.pmin, dtype)
            hi = jnp.asarray(self.pmax, dtype)
            return (
                jax.random.uniform(key, (n, d), dtype, lo, hi),
                jnp.full((n,), jnp.inf, dtype),  # always accept
            )

        if self.walk == "demc":
            k1, k2, k3, k4 = jax.random.split(key, 4)
            r1 = jax.random.randint(k1, (n,), 0, n - 1)
            r1 = jnp.where(r1 >= jnp.arange(n), r1 + 1, r1)  # r1 != i
            r2 = jax.random.randint(k2, (n,), 0, n - 2)
            # r2 != i and r2 != r1 (order-stable double skip):
            lo12 = jnp.minimum(jnp.arange(n), r1)
            hi12 = jnp.maximum(jnp.arange(n), r1)
            r2 = jnp.where(r2 >= lo12, r2 + 1, r2)
            r2 = jnp.where(r2 >= hi12, r2 + 1, r2)
            gamma = gamma_scale * 2.38 / jnp.sqrt(2.0 * d)
            jump = jax.random.uniform(k3, (n, 1), dtype) < self.gamma_jump_frac
            g = jnp.where(jump, 1.0, gamma)
            noise = self.eps * jax.random.normal(k4, (n, d), dtype)
            xnew = pos + g * (pos[r1] - pos[r2]) + noise
            return fold(xnew), jnp.zeros(n, dtype)

        if self.walk == "snooker":
            keys = jax.random.split(key, 6)
            nz_eff = jnp.maximum(state.z_count, 3)
            z1 = jax.random.randint(keys[0], (n,), 0, nz_eff)
            z2 = jax.random.randint(keys[1], (n,), 0, nz_eff)
            z3 = jax.random.randint(keys[2], (n,), 0, nz_eff)
            Z = state.z_archive
            gamma = gamma_scale * 2.38 / jnp.sqrt(2.0 * d)
            noise = self.eps * jax.random.normal(keys[3], (n, d), dtype)
            # parallel-direction move: symmetric step kernel -> fold at
            # the bounds; the snooker move keeps its |x'-z| Metropolis
            # correction and is left unfolded (out-of-bounds snooker
            # proposals reject as before)
            x_par = fold(pos + gamma * (Z[z1] - Z[z2]) + noise)

            # snooker move along (x - z3):
            gs = jax.random.uniform(keys[4], (n, 1), dtype, 1.2, 2.2)
            dz = pos - Z[z3]
            dz_norm2 = jnp.maximum(jnp.sum(dz * dz, axis=1, keepdims=True), 1e-300)
            proj = lambda v: (jnp.sum(v * dz, axis=1, keepdims=True) / dz_norm2) * dz
            x_sn = pos + gs * (proj(Z[z1]) - proj(Z[z2]))
            # MH correction |x'-z|^{d-1} / |x-z|^{d-1}:
            num = jnp.sum((x_sn - Z[z3]) ** 2, axis=1)
            den = jnp.sum(dz * dz, axis=1)
            log_corr_sn = 0.5 * (d - 1) * (
                jnp.log(jnp.maximum(num, 1e-300))
                - jnp.log(jnp.maximum(den, 1e-300))
            )

            use_sn = jax.random.uniform(keys[5], (n,), dtype) < self.snooker_frac
            xnew = jnp.where(use_sn[:, None], x_sn, x_par)
            log_corr = jnp.where(use_sn, log_corr_sn, 0.0)
            return xnew, log_corr

        raise ValueError(f"unknown walk {self.walk!r}")

    # ------------------------------------------------------------------
    def _step(self, state: SamplerState, key,
              tables: dict | None = None,
              gamma_scale=None) -> SamplerState:
        if gamma_scale is None:
            gamma_scale = self.fgamma
        kp, ka = jax.random.split(key)
        xnew, log_corr = self._propose(kp, state, gamma_scale)
        logl_new, models_new = self._eval(xnew, tables)

        log_ratio = logl_new - state.loglike + log_corr
        u = jax.random.uniform(ka, (self.nchains,), state.positions.dtype)
        accept = jnp.log(u) < log_ratio
        if self.walk == "unif":
            accept = jnp.isfinite(logl_new)  # sweep: record valid draws

        pos = jnp.where(accept[:, None], xnew, state.positions)
        logl = jnp.where(accept, logl_new, state.loglike)
        models = jnp.where(accept[:, None], models_new, state.models)

        # archive append every z_thin iterations (ring buffer):
        do_append = (state.niter % self.z_thin) == 0
        nz = self.nz
        idx = (state.z_count + jnp.arange(self.nchains)) % nz
        z_new = state.z_archive.at[idx].set(pos)
        z_archive = jnp.where(do_append, z_new, state.z_archive)
        z_count = jnp.where(
            do_append,
            jnp.minimum(state.z_count + self.nchains, nz),
            state.z_count,
        )

        ibest = jnp.argmax(logl)
        better = logl[ibest] > state.best_loglike
        return SamplerState(
            positions=pos,
            loglike=logl,
            models=models,
            z_archive=z_archive,
            z_count=z_count.astype(jnp.int32),
            best_pos=jnp.where(better, pos[ibest], state.best_pos),
            best_loglike=jnp.where(better, logl[ibest], state.best_loglike),
            naccept=state.naccept + accept.astype(jnp.int32),
            niter=state.niter + 1,
        )

    # ------------------------------------------------------------------
    def run_block(self, state: SamplerState, key, nsteps: int,
                  fgamma: float | None = None):
        """Advance ``nsteps`` iterations in one device call.

        ``fgamma`` overrides the DE gamma scale for this block (traced
        as a device scalar: adapting it between blocks does not
        recompile).  Returns (state, positions_block[nsteps, nchain,
        nfree], loglike_block[nsteps, nchain],
        models_block[nsteps, nchain, m]).
        """
        if self._run_block is None:
            @functools.partial(jax.jit, static_argnames="nsteps")
            def _run(state, key, tables, gscale, nsteps):
                keys = jax.random.split(key, nsteps)

                def body(st, k):
                    st = self._step(st, k, tables, gscale)
                    return st, (st.positions, st.loglike, st.models)

                return jax.lax.scan(body, state, keys)

            self._run_block = _run
        gscale = jnp.asarray(
            self.fgamma if fgamma is None else fgamma,
            state.positions.dtype)
        state, (pb, lb, mb) = self._run_block(state, key, self._tables,
                                              gscale, nsteps)
        return state, pb, lb, mb

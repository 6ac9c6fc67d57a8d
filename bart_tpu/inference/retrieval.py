"""Retrieval orchestration: blocks of on-device MCMC + host-side control.

Equivalent of MC3's mccubed.py driver (reference: SURVEY.md sections
2.3/3.2) with an accelerator execution model: the chain ensemble
advances in jitted blocks (one device call per ``block`` iterations);
between blocks the host runs the Gelman-Rubin test (grtest/grexit),
accumulates the posterior, streams savemodel outputs, and writes
checkpoints — giving mid-run resume capability the reference lacks
(its chains restart from zero, SURVEY.md section 5).

Outputs are reference-compatible:
* ``output.npy``  posterior tensor [nchain, nfree, niter]
                  (code/bestFit.py:431-433 layout)
* ``MCMC.log``    with a " Best-fit params" block parseable by
                  bestFit.read_MCMC_out (code/bestFit.py:55-92)
* ``savemodel``   band-flux tensor [nchain, nmodel, niter]
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from bart_tpu.inference.gr import (effective_sample_size, gelman_rubin,
                                   split_rhat_rank)
from bart_tpu.inference.likelihood import Likelihood, ParamSpace
from bart_tpu.inference.samplers import EnsembleSampler, SamplerState

__all__ = ["RetrievalResult", "run_mcmc", "least_squares_prefit",
           "save_checkpoint", "load_checkpoint"]


class _SampleStore:
    """Append-only per-iteration sample store, [cap, nchain, nparam].

    Iteration-major layout keeps every append a contiguous write, so a
    disk-backed store (``path`` given) costs O(block) per flush — the
    checkpoint .npz then only carries the small sampler state, never the
    accumulated posterior (fixes the O(N^2) re-concatenation the round-1
    checkpointing had)."""

    def __init__(self, nchain: int, nparam: int, cap: int, dtype,
                 path: str | None = None, n0: int = 0):
        self.path = path
        self.cap = cap
        dt = np.dtype(dtype)
        if path is not None:
            nbytes = cap * nchain * nparam * dt.itemsize
            # create, or extend in place when resuming to a longer run
            with open(path, "ab") as f:
                if f.tell() < nbytes:
                    f.truncate(nbytes)
            self.buf = np.memmap(path, dt, "r+", shape=(cap, nchain, nparam))
        else:
            self.buf = np.empty((cap, nchain, nparam), dt)
        self.n = n0

    def append(self, block) -> None:
        """block: [nsteps, nchain, nparam] (the sampler's native order)."""
        ns = block.shape[0]
        self.buf[self.n:self.n + ns] = block
        self.n += ns

    def flush(self) -> None:
        if self.path is not None:
            self.buf.flush()

    def iterations(self, start: int = 0) -> np.ndarray:
        """[nsteps, nchain, nparam] view of iterations [start, n)."""
        return self.buf[start:self.n]

    def samples(self, start: int = 0, step: int = 1) -> np.ndarray:
        """[nchain, nparam, nsteps] — the reference's output.npy layout
        (code/bestFit.py:431-433)."""
        return np.array(self.buf[start:self.n:step]).transpose(1, 2, 0)


def save_checkpoint(path: str, state: SamplerState, done_iters: int,
                    key, fgamma: float = 1.0) -> None:
    """Persist the sampler state mid-run (capability the reference
    lacks: its chains restart from zero, SURVEY.md section 5).  The
    posterior/model history lives in memmap sidecars (``<path>.pos.dat``
    / ``<path>.mod.dat``) flushed incrementally by _SampleStore."""
    arrays = {f"state/{k}": np.asarray(v) for k, v in state._asdict().items()}
    arrays["done_iters"] = np.asarray(done_iters)
    arrays["key"] = jax.random.key_data(key)
    arrays["fgamma"] = np.asarray(fgamma)
    np.savez(path, **arrays)


def load_checkpoint(path: str):
    """-> (state, done_iters, key, fgamma)."""
    z = np.load(path)
    state = SamplerState(**{
        k.split("/", 1)[1]: jnp.asarray(z[k])
        for k in z.files if k.startswith("state/")
    })
    key = jax.random.wrap_key_data(jnp.asarray(z["key"]))
    fgamma = float(z["fgamma"]) if "fgamma" in z.files else 1.0
    return state, int(z["done_iters"]), key, fgamma


@dataclasses.dataclass
class RetrievalResult:
    posterior: np.ndarray      # [nchain, nfree, niter] post burn-in
    models: np.ndarray | None  # [nchain, nmodel, niter_total] if savemodel
                               # (full history incl. burn-in, like MC3)
    bestp: np.ndarray          # [nfree]
    best_loglike: float
    accept_rate: float
    psrf: np.ndarray           # final Gelman-Rubin per free param
    pnames: list[str]
    space: ParamSpace
    niter_total: int
    converged: bool
    psrf_rank: np.ndarray | None = None  # rank-normalized split-R-hat
    fgamma_final: float = 1.0  # DE gamma scale after burn-in adaptation
    ess: np.ndarray | None = None  # bulk effective sample size per param


def least_squares_prefit(like: Likelihood, space: ParamSpace):
    """Optional Levenberg-Marquardt pre-fit (the reference's
    leastsq=True via scipy, SURVEY.md 2.3), using JAX gradients."""
    import scipy.optimize as so

    def resid(free):
        logl, model = like(jnp.asarray(free))
        r = np.asarray((model - like.data) / like.uncert)
        return np.where(np.isfinite(r), r, 1e10)

    out = so.least_squares(
        resid, space.free_init,
        bounds=(space.free_min, space.free_max), method="trf",
    )
    return out.x


def run_mcmc(
    like: Likelihood,
    space: ParamSpace,
    *,
    nchains: int = 10,
    numit: int = 50000,
    burnin: int = 500,
    walk: str = "snooker",
    seed: int = 0,
    block: int = 100,
    thinning: int = 1,
    grtest: bool = True,
    grexit: bool = False,
    grbreak: float = 1.01,
    leastsq: bool = False,
    chisqscale: bool = False,
    init: np.ndarray | None = None,
    savefile: str | None = None,
    savemodel: str | None = None,
    modelper: int = 0,
    logfile: str | None = None,
    checkpoint: str | None = None,
    checkpoint_every: int = 20,
    resume: bool = False,
    fgamma: float = 1.0,
    snooker_frac: float = 0.1,
    z_thin: int = 30,
    verbose: bool = True,
    dtype=jnp.float64,
) -> RetrievalResult:
    """Run a retrieval.  ``numit`` is the TOTAL number of samples
    across chains (reference numit semantics: demo numit=5e4 with
    nchains=3 -> ~16.7k iterations per chain)."""
    t_start = time.time()
    log_lines: list[str] = []

    def log(msg):
        if verbose:
            print(msg)
        log_lines.append(msg)

    if chisqscale:
        # scale uncertainties for reduced chi2 == 1 at the initial guess
        logl0, model0 = like(jnp.asarray(space.free_init))
        chi0 = float(-2.0 * logl0)
        dof = max(len(np.asarray(like.data)) - space.nfree, 1)
        scale = np.sqrt(chi0 / dof)
        like.uncert = like.uncert * scale
        log(f"chisqscale: uncertainties scaled by {scale:.4f}")

    init_free = None
    if init is not None:
        init_free = np.asarray(init)
    elif leastsq:
        log("least-squares pre-fit...")
        fit = least_squares_prefit(like, space)
        log(f"  prefit: {fit}")
        rng = np.random.default_rng(seed)
        jitter = 0.01 * (space.free_max - space.free_min)
        init_free = np.clip(
            fit[None, :] + rng.normal(0, 1, (nchains, space.nfree)) * jitter,
            space.free_min, space.free_max,
        )

    sampler = EnsembleSampler(
        loglike_fn=like,
        nfree=space.nfree,
        nmodel=len(np.asarray(like.data)),
        nchains=nchains,
        walk=walk,
        pmin=space.free_min,
        pmax=space.free_max,
        stepsize=space.stepsize[space.ifree],
        fgamma=fgamma,
        snooker_frac=snooker_frac,
        z_thin=z_thin,
    )
    key = jax.random.key(seed)
    key, k0 = jax.random.split(key)

    done0 = 0
    fg = float(fgamma)
    if resume and checkpoint and os.path.isfile(checkpoint):
        state, done0, key, fg = load_checkpoint(checkpoint)
        nz_ckpt = int(state.z_archive.shape[0])
        if nz_ckpt != sampler.nz:
            # A checkpoint written under a different archive-size
            # default must win: the ring-buffer index math in _step
            # uses sampler.nz, and a mismatch produces out-of-bounds
            # scatter/gather that JAX silently clamps — the snooker
            # archive would degrade statistically with no error.
            log(f"checkpoint z-archive size {nz_ckpt} != configured "
                f"{sampler.nz}; using the checkpoint's size")
            sampler.nz = nz_ckpt
        log(f"resumed from {checkpoint} at iteration {done0} "
            f"(fgamma {fg:.3f})")
    else:
        state = sampler.init_state(k0, init_free, dtype=dtype)

    iters_per_chain = max(int(np.ceil(numit / nchains)), block)
    nblocks = int(np.ceil(max(iters_per_chain - done0, 0) / block))
    cap = done0 + nblocks * block
    np_dtype = np.dtype(jnp.zeros((), dtype).dtype)
    pos_store = _SampleStore(
        nchains, space.nfree, cap, np_dtype,
        path=(checkpoint + ".pos.dat") if checkpoint else None, n0=done0,
    )
    model_store = (
        _SampleStore(nchains, sampler.nmodel, cap, np_dtype,
                     path=(checkpoint + ".mod.dat") if checkpoint else None,
                     n0=done0)
        if savemodel else None
    )
    psrf = np.full(space.nfree, np.inf)
    psrf_rank = np.full(space.nfree, np.inf)
    converged = False
    done_iters = done0
    # Burn-in gamma adaptation (the reference's MC3 tunes its DE gamma
    # via fgamma; here it is automatic): multiplicative feedback with a
    # DEADBAND — gamma stays at the canonical 2.38/sqrt(2d) scale
    # (which mixes fastest) unless the block acceptance is pathological
    # (< 0.15: steps far too big for the posterior's conditioning;
    # > 0.45: steps too timid).  Active only over the SECOND half of
    # burn-in: during the initial descent from random starts the
    # acceptance rate reflects distance from the typical set, not the
    # proposal scale, and adapting on it slams gamma to the floor and
    # strands chains in wrong modes (measured on the demo retrieval).
    # Frozen at the end of burn-in so the post-burn-in chain is a
    # fixed-kernel Markov chain.
    adapt_gamma = walk in ("snooker", "demc")
    acc_lo, acc_hi = 0.15, 0.45
    fg_floor = 0.25
    prev_nacc = float(np.asarray(state.naccept).sum())
    for ib in range(nblocks):
        key, kb = jax.random.split(key)
        state, pb, lb, mb = sampler.run_block(state, kb, block, fgamma=fg)
        done_iters += block
        pos_store.append(np.asarray(pb))        # [nsteps, nchain, nfree]
        if model_store is not None:
            model_store.append(np.asarray(mb))

        if adapt_gamma and done_iters <= burnin:
            nacc = float(np.asarray(state.naccept).sum())
            block_acc = (nacc - prev_nacc) / (block * nchains)
            prev_nacc = nacc
            if done_iters > burnin // 2:
                # gain sized so the correction converges within a
                # typical adaptation window (~10 blocks): a block 0.08
                # below the floor shrinks gamma by ~0.73x
                if block_acc < acc_lo:
                    fg_new = fg * float(np.exp(4.0 * (block_acc - acc_lo)))
                elif block_acc > acc_hi:
                    fg_new = fg * float(np.exp(2.0 * (block_acc - acc_hi)))
                else:
                    fg_new = fg
                fg = float(np.clip(fg_new, fg_floor, 2.0))
            if done_iters + block > burnin:
                log(f"burn-in gamma adaptation frozen: fgamma {fg:.3f}"
                    f" (block accept {block_acc:.3f})")

        if checkpoint and (ib + 1) % checkpoint_every == 0:
            pos_store.flush()
            if model_store is not None:
                model_store.flush()
            save_checkpoint(checkpoint, state, done_iters, key, fg)

        if grtest and done_iters > burnin and (ib + 1) % 10 == 0:
            chains = np.asarray(
                pos_store.iterations(start=burnin)).transpose(1, 0, 2)
            psrf = gelman_rubin(chains)
            psrf_rank = split_rhat_rank(chains)
            log(
                f"iter {done_iters*nchains:8d}/{numit}  "
                f"GR: {np.array2string(psrf, precision=4)}  "
                f"split-Rhat: {np.array2string(psrf_rank, precision=4)}  "
                f"accept: {float(state.naccept.sum())/ (done_iters*nchains):.3f}"
            )
            # Early exit gates on the rank-normalized split-R-hat, the
            # strictly stronger statistic: plain GR can read converged
            # on heavy-tailed/plateau posteriors (the demo problem's
            # CH4 marginal is plateau-dominated at demo S/N) while the
            # split/rank form still detects within-chain drift and
            # tail mis-mixing.
            if grexit and np.all(psrf_rank < grbreak):
                log("split-R-hat convergence reached — early exit (grexit).")
                converged = True
                break

    posterior = pos_store.samples(start=burnin, step=thinning)
    # models keep the FULL iteration history (no burn-in slicing): the
    # reference's MC3 savemodel records every iteration's model, and
    # modelper splits count raw iterations (BART.py:208-216).
    models = model_store.samples() if model_store is not None else None
    ess = None
    if grtest:
        chains = np.asarray(
            pos_store.iterations(start=burnin)).transpose(1, 0, 2)
        psrf = gelman_rubin(chains)
        psrf_rank = split_rhat_rank(chains)
        ess = effective_sample_size(chains)
        el = max(time.time() - t_start, 1e-9)
        log(f"bulk ESS: {np.array2string(ess, precision=0)}  "
            f"(min ESS/s {np.nanmin(ess)/el:.2f})")
        converged = converged or bool(np.all(psrf_rank < grbreak))

    bestp = np.asarray(state.best_pos)
    best_logl = float(state.best_loglike)
    accept = float(state.naccept.sum()) / (done_iters * nchains)
    elapsed = time.time() - t_start
    total = done_iters * nchains
    log(
        f"MCMC done: {total} samples in {elapsed:.1f}s "
        f"({total/elapsed:.0f} samples/s), accept={accept:.3f}"
    )
    log(f"best chi2 = {-2*best_logl:.4f}")

    pnames = (
        [space.pnames[i] for i in space.ifree]
        if space.pnames else [f"p{i}" for i in space.ifree]
    )

    # posterior std for the log's uncert column:
    uncert = posterior.transpose(1, 0, 2).reshape(space.nfree, -1).std(axis=1)

    if savefile:
        np.save(savefile, posterior)
    if checkpoint:
        pos_store.flush()
        if model_store is not None:
            model_store.flush()
        save_checkpoint(checkpoint, state, done_iters, key, fg)
    if savemodel and models is not None:
        np.save(savemodel, models)
        if modelper > 0:
            # Split every ``modelper`` raw iterations per chain, i.e.
            # modelper*nchains models per numbered file (reference
            # semantics: "If nchains=10 and modelper=5, it will save
            # every 50 models to a new .NPY file", BART.py:208-216).
            base, ext = os.path.splitext(savemodel)
            nsplit = -(-models.shape[2] // modelper)
            split_files = []
            for k in range(nsplit):
                fname = f"{base}{k:02d}{ext}"
                np.save(fname, models[:, :, k * modelper:(k + 1) * modelper])
                split_files.append(fname)
            if walk == "unif":
                # unif sweeps move the numbered model files into a
                # subdirectory named after savemodel (BART.py:582-597)
                mdir = base
                os.makedirs(mdir, exist_ok=True)
                for fname in split_files:
                    os.replace(fname,
                               os.path.join(mdir, os.path.basename(fname)))
    if logfile:
        with open(logfile, "w") as f:
            f.write("\n".join(log_lines) + "\n\n")
            # " Best-fit params" block, parseable by the reference's
            # bestFit.read_MCMC_out (code/bestFit.py:74-92):
            f.write(" Best-fit params    Uncertainties   S/N      Sample "
                    "Span\n")
            for j in range(space.nfree):
                sn = abs(bestp[j]) / uncert[j] if uncert[j] > 0 else 0.0
                f.write(
                    f" {bestp[j]: .7e}  {uncert[j]: .7e}  {sn:9.2f}  "
                    f"{pnames[j]}\n"
                )
            f.write("\n")

    return RetrievalResult(
        posterior=posterior,
        models=models,
        bestp=bestp,
        best_loglike=best_logl,
        accept_rate=accept,
        psrf=psrf,
        pnames=pnames,
        space=space,
        niter_total=total,
        converged=converged,
        psrf_rank=psrf_rank,
        fgamma_final=fg,
        ess=ess,
    )

"""Fused forward kernels: extinction -> optical depth -> spectrum.

The gridded-opacity hot path (reference SURVEY.md 3.2: opacity
interpolation at the sampled T -> extinction -> tau -> Planck ->
emergent flux, i.e. the body of transit's ``run_transit``) expressed
as ONE rows-contraction per layer.

Generalized extinction contract: every absorber the forward model
supports is separable into (per-chain-per-layer weight) x (static
table row over wn), so the whole extinction is

    ext[l, w] = sum_r wrows[l, r] tab[r, l, w]

* line opacity     rows (mol, T-node): weight = T-interp x n_mol
                   (reference extinction.c interpolation, SURVEY 2.2)
* CIA              rows (T-node):      weight = T-interp x n1 n2
                   (cia.c; wn-interp of the table hoisted to setup)
* Rayleigh         one row sigma(wn):  weight = 10^param x n_H2
                   (set_scattering modes 1 and 2, BARTfunc.py:356-360)
* gray cloud deck  one row of ones:    weight = kappa x ramp(p or r)
                   (set_cloudtop / cloudrad+cloudext flags)

Each entry point is a per-sample function that ``jax.vmap`` batches
over chains.  The per-sample bodies (``_single`` and friends) are the
plain jnp reference.  The eclipse K=1 entry ``fused_eclipse`` is a
``jax.custom_batching.custom_vmap``: under ``vmap`` on a GPU the whole
chain batch runs as one Pallas kernel compiled through Triton
(``_kernel``), which streams the LAYER axis — for each (chain block,
wn tile) program a loop walks the layers keeping only [chains, tile]
values in registers —

    ext_l  = wrows_l @ tab[:, l, :]                         (tensor core)
    tau_l  = tau_{l-1} + 0.5 (ext_{l-1} + ext_l) dr_l
    B_l    = Planck(T_l, wn)
    S_l    = sum_k w_k mu_k exp(-tau_l / mu_k)
    F     += 0.5 (B_{l-1} + B_l) (S_{l-1} - S_l)

with the closing boundary term F += B_bot S_bot (the exact isothermal
limit, matching rt.eclipse.eclipse_intensity's summation form).  The
plain path instead materializes [chains, layers, wn] extinction, tau,
S and B.  Elsewhere (the CPU) the batch is the vmapped plain path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as pltriton
from jax.sharding import NamedSharding, PartitionSpec as P

from bart_tpu import constants as const
from bart_tpu.rt.tau import TAU_CLAMP

__all__ = [
    "fused_eclipse", "fused_transit", "fused_eclipse_folded",
    "fused_transit_folded", "interp_weights", "fold_table", "use_kernel",
]

_C1 = 2.0 * const.H_PLANCK * const.C_LIGHT**2   # 2 h c^2

# Eclipse kernel launch shape: a (chain block x wn tile) program keeps
# five [CHAIN_BLOCK, WN_TILE] f32 carries in registers; powers of two
# as Triton requires.  Chosen by timing 11 shapes at 512 chains on an
# H100 (PERF.md): (32, 64, 4 warps, 3 stages) had the best median.
CHAIN_BLOCK = 32
WN_TILE = 64
NUM_WARPS = 4
NUM_STAGES = 3

# Test hook: run the kernel through the Pallas interpreter (and hence
# choose it on any backend).
INTERPRET: bool = False


def use_kernel(backend: str | None = None) -> bool:
    """The one dispatch rule: the eclipse kernel on a GPU (or in the
    interpreter when INTERPRET is set), the vmapped plain path
    elsewhere."""
    backend = backend or jax.default_backend()
    return INTERPRET or backend == "gpu"


def interp_weights(n_nodes, t_min, t_step, T):
    """Uniform-grid linear-interpolation weights w[..., n_nodes]
    (identical bracketing/clamping to opacity.grid.interp_opacity)."""
    x = (T - t_min) / t_step
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_nodes - 2)
    f = jnp.clip(x - i0, 0.0, 1.0)
    t_iota = jnp.arange(n_nodes)
    w = jnp.where(t_iota == i0[..., None], 1.0 - f[..., None], 0.0)
    w = jnp.where(t_iota == i0[..., None] + 1, w + f[..., None], w)
    return w


def _smix_jnp(tau, mu, muw, powers):
    """S[...] = sum_q w_q mu_q e^{-tau/mu_q}; in powers mode (expsum
    quadrature, rt.eclipse.expsum_weights: mu_q = 1/(q+1)) evaluated as
    the Horner polynomial sum_q a_q u^{q+1} of u = e^{-tau} — one
    exponential for the whole quadrature."""
    tau_c = jnp.minimum(tau, TAU_CLAMP)
    a = muw * mu
    if powers:
        u = jnp.exp(-tau_c)
        acc = jnp.zeros_like(u)
        for q in reversed(range(mu.shape[0])):
            acc = u * (a[q] + acc)
        return acc
    S = jnp.zeros_like(tau_c)
    for q in range(mu.shape[0]):
        S = S + a[q] * jnp.exp(-tau_c / mu[q])
    return S


def _single(tab, wn, mu, muw, wrows, T, drp, powers=False):
    """Reference jnp path, one sample (same math as the unfused
    pipeline: extinction einsum + rt.tau.tau_vertical +
    rt.eclipse.eclipse_flux)."""
    from bart_tpu.rt.eclipse import eclipse_flux

    ext = jnp.einsum("lr,rlw->lw", wrows, tab,
                     precision=jax.lax.Precision.HIGHEST)
    seg = 0.5 * (ext[:-1] + ext[1:]) * drp[1:, None]
    tri = jnp.tril(jnp.ones((seg.shape[0], seg.shape[0]), seg.dtype))
    tau = jax.lax.dot_general(
        tri, seg, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    tau = jnp.concatenate([jnp.zeros_like(tau[:1]), tau], axis=0)
    if not powers:
        return eclipse_flux(tau, T, wn, mu, muw)
    # powers mode: S via Horner, flux via the same summation-by-parts
    S = _smix_jnp(tau, mu, muw, True)                          # [L, W]
    wn3 = _C1 * wn**3
    B = wn3[None, :] / (jnp.exp(const.C2 * wn[None, :] / T[:, None]) - 1.0)
    Bmid = 0.5 * (B[:-1] + B[1:])
    flux = jnp.sum(Bmid * (S[:-1] - S[1:]), axis=0)
    return 2.0 * jnp.pi * (flux + B[-1] * S[-1])


def _kernel(tab_ref, w_ref, T_ref, dr_ref, wn_ref, quad_ref, out_ref, *,
            L, nmu, powers, cb, tile):
    """One (chain block, wn tile) program of the eclipse recurrence.

    tab_ref [L, Rp, Wp] layer-major table; w_ref [L, Cp, Rp] weight
    rows; T_ref, dr_ref [L, Cp] temperature and radius segment
    dr_{l-1,l} [cm]; wn_ref [Wp]; quad_ref [2, nmu] = (w_q mu_q,
    1/mu_q).  All refs are whole arrays in device memory; the program
    loads its [cb, *] and [*, tile] slices per layer.
    """
    cs = pl.ds(pl.program_id(0) * cb, cb)
    ws = pl.ds(pl.program_id(1) * tile, tile)
    wn = wn_ref[ws]
    wn3 = (_C1 * wn * wn * wn)[None, :]                       # [1, tile]
    c2wn = (const.C2 * wn)[None, :]
    a = [quad_ref[0, q] for q in range(nmu)]
    minv = [quad_ref[1, q] for q in range(nmu)]

    def planck(l):                                            # -> [cb, tile]
        return wn3 / (jnp.exp(c2wn / T_ref[l, cs][:, None]) - 1.0)

    def smix(tau):
        tau_c = jnp.minimum(tau, TAU_CLAMP)
        if powers:
            u = jnp.exp(-tau_c)
            acc = jnp.zeros_like(tau)
            for q in reversed(range(nmu)):
                acc = u * (a[q] + acc)
            return acc
        acc = jnp.zeros_like(tau)
        for q in range(nmu):
            acc = acc + a[q] * jnp.exp(-tau_c * minv[q])
        return acc

    def ext(l):
        # full f32 products (no TF32): the tolerance of the band fluxes
        # against the f64 reference was set with HIGHEST contractions
        return pl.dot(w_ref[l, cs, :], tab_ref[l, :, ws], allow_tf32=False)

    ext0 = ext(0)
    zero = jnp.zeros_like(ext0)

    def body(l, carry):
        ext_p, tau_p, B_p, S_p, flux = carry
        ext_l = ext(l)
        tau_l = tau_p + 0.5 * (ext_p + ext_l) * dr_ref[l, cs][:, None]
        B_l = planck(l)
        S_l = smix(tau_l)
        flux = flux + 0.5 * (B_p + B_l) * (S_p - S_l)
        return ext_l, tau_l, B_l, S_l, flux

    _, _, B_b, S_b, flux = jax.lax.fori_loop(
        1, L, body, (ext0, zero, planck(0), smix(zero), zero))
    out_ref[...] = 2.0 * jnp.pi * (flux + B_b * S_b)


def _pow2(n, floor):
    return max(floor, 1 << (int(n) - 1).bit_length())


def _kernel_batch(tab, wn, mu, muw, wrows, T, drp, *, powers):
    """Batched eclipse kernel: wrows [C, L, R], T [C, L], drp [C, L]
    -> flux [C, W].  Pads rows to a power of two >= 16 (zero rows),
    chains to the chain block (T = 1000 K, dr = 0: finite, discarded)
    and wn to the tile (wn = 1: finite, discarded)."""
    f32 = jnp.float32
    R, L, W = tab.shape
    C = T.shape[0]
    nmu = int(mu.shape[0])
    cb = min(CHAIN_BLOCK, _pow2(C, 16))
    tile = WN_TILE
    Rp = _pow2(R, 16)
    Cp = -(-C // cb) * cb
    Wp = -(-W // tile) * tile
    tab_t = jnp.pad(jnp.transpose(tab.astype(f32), (1, 0, 2)),
                    ((0, 0), (0, Rp - R), (0, Wp - W)))        # [L, Rp, Wp]
    w_t = jnp.pad(jnp.transpose(wrows.astype(f32), (1, 0, 2)),
                  ((0, 0), (0, Cp - C), (0, Rp - R)))          # [L, Cp, Rp]
    T_t = jnp.pad(T.astype(f32).T, ((0, 0), (0, Cp - C)),
                  constant_values=1000.0)                      # [L, Cp]
    dr_t = jnp.pad(drp.astype(f32).T, ((0, 0), (0, Cp - C)))
    wn_p = jnp.pad(wn.astype(f32), (0, Wp - W), constant_values=1.0)
    quad = jnp.stack([muw * mu, 1.0 / mu]).astype(f32)         # [2, nmu]
    out = pl.pallas_call(
        functools.partial(_kernel, L=L, nmu=nmu, powers=powers, cb=cb,
                          tile=tile),
        grid=(Cp // cb, Wp // tile),
        out_specs=pl.BlockSpec((cb, tile), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((Cp, Wp), f32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=INTERPRET,
        name="fused_eclipse",
    )(tab_t, w_t, T_t, dr_t, wn_p, quad)
    return out[:C, :W]


def _axis(spec, i):
    return spec[i] if i < len(spec) else None


@functools.lru_cache(maxsize=None)
def _partitioned_kernel(powers: bool):
    """``_kernel_batch`` as a custom_partitioning op: on a (chain, wn)
    mesh each device runs the kernel on its own chain and wn shard
    (every output element depends only on its own chain and wn), so
    sharded tables are never gathered."""
    def batch(tab, wn, mu, muw, wrows, T, drp):
        return _kernel_batch(tab, wn, mu, muw, wrows, T, drp, powers=powers)

    fn = custom_partitioning(batch)

    def shardings(mesh, out_spec):
        c, w = _axis(out_spec, 0), _axis(out_spec, 1)

        def s(*axes):
            return NamedSharding(mesh, P(*axes))

        args = (s(None, None, w), s(w), s(), s(),
                s(c, None, None), s(c, None), s(c, None))
        return args, s(c, w)

    def infer(mesh, arg_shapes, result_shape):
        c = _axis(arg_shapes[4].sharding.spec, 0)
        w = _axis(arg_shapes[0].sharding.spec, 2)
        return NamedSharding(mesh, P(c, w))

    def partition(mesh, arg_shapes, result_shape):
        args, out = shardings(mesh, result_shape.sharding.spec)
        return mesh, batch, out, args

    fn.def_partition(
        partition=partition,
        infer_sharding_from_operands=infer,
        sharding_rule="r l w, w, q, q, c l r, c l, c l -> c w",
        need_replication_factors=("r", "l", "q"),
    )
    return fn


@functools.lru_cache(maxsize=None)
def _eclipse_entry(powers: bool):
    """custom_vmap eclipse entry specialized on ``powers`` (cached so
    every ForwardModel with the same quadrature shares one jaxpr)."""
    single = functools.partial(_single, powers=powers)

    @jax.custom_batching.custom_vmap
    def entry(tab, wn, mu, muw, wrows, T, drp):
        return single(tab, wn, mu, muw, wrows, T, drp)

    @entry.def_vmap
    def _vmap(axis_size, in_batched, *args):
        chain_batch = (False,) * 4 + (True,) * 3
        if tuple(in_batched) == chain_batch and use_kernel():
            out = _partitioned_kernel(powers)(*args)
            return out.astype(args[5].dtype), True
        axes = tuple(0 if b else None for b in in_batched)
        return jax.vmap(single, in_axes=axes)(*args), True

    return entry


def fused_eclipse(tab, wn, mu, muw, wrows, T, drp, powers=False):
    """Eclipse flux F[wn] from extinction rows, one sample.

    tab [rows, layer, wn] static absorber rows; wrows [layer, rows]
    per-sample weights; T [layer] K; drp [layer] cm with drp[0] == 0
    (drp[l] = r_{l-1} - r_l).  Under ``vmap`` over (wrows, T, drp) the
    batch runs as one fused kernel on a GPU (``use_kernel``).
    ``powers=True`` requires the expsum quadrature
    (rt.eclipse.expsum_weights).
    """
    return _eclipse_entry(powers)(tab, wn, mu, muw, wrows, T, drp)


# ---------------------------------------------------------------------
# Transit (transmission) geometry.
#
# Same rows-contraction extinction contract, but the geometry is
# slant-path: with (G, wgt) = rt.transit_geom.slant_geometry the whole
# per-sample observable is three contractions
#
#     ext = wrows @ tab          [L, W]   (T-interp x line/CIA/... rows)
#     tau = G @ ext              [L, W]   (slant-path quadrature)
#     out = wgt @ (1 - e^-tau)   [W]      (annulus trapezoid)
#
# and depth = (r_deep^2 + out) / r_star^2 is finished by the caller.
# Batched over chains these are batched GEMMs, which XLA hands to the
# GPU's matrix libraries, so transit has no kernel of its own.


def fused_transit(tab, wrows, G, wgt):
    """Annulus-integrated absorption out[wn] (see slant_geometry), one
    sample.  tab [rows, layer, wn] static absorber rows; wrows
    [layer, rows] per-sample weights; (G [layer, layer], wgt [layer])
    from slant_geometry of the per-sample radii."""
    ext = jnp.einsum("lr,rlw->lw", wrows, tab,
                     precision=jax.lax.Precision.HIGHEST)
    tau = jax.lax.dot_general(
        G, ext, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    absorb = 1.0 - jnp.exp(-jnp.minimum(tau, TAU_CLAMP))
    return jnp.einsum("l,lw->w", wgt, absorb,
                      precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------
# Folded rtosamp: publication-accuracy band fluxes WITHOUT the
# plain-rtosamp mode's K-times-larger outputs and band matrix.
#
# The unbiased high-fidelity scheme (docs/LINE_SAMPLING.md) evaluates
# extinction -> tau -> exp(-tau) on a K-times-finer midpoint grid
# inside each output bin and averages the SPECTRUM (after the exp
# nonlinearity) back to the output bins.  Plain `rtosamp` does this by
# running the whole pipeline on the fine grid — K x the outputs, the
# band matrix, and (for eclipse) K x the Planck exponentials.  The
# folded form keeps the fine grid as a leading sub-sample axis of the
# table, [K, R, L, Wout] (``fold_table``), and averages the source
# function Sbar[l] = avg_k S_l (eclipse) or the absorption
# avg_k (1 - e^-tau) (transit) over it, so the Planck-weighted layer
# sum (eclipse) or annulus quadrature (transit) runs once on the
# output bins.  The sub-samples are visited one at a time (lax.scan),
# so the working set is that of one sub-sample.
#
# Planck is evaluated at the bin-center wavenumber: B varies by
# ~0.7 x (wndelt/wn) ~ 2e-4 across a 1 cm-1 bin and enters averaged
# against the mean-zero in-bin variation of S, a second-order ~1e-7
# band-flux effect (pinned in tests/test_fused.py) — in exchange the
# Planck exponential count drops K-fold, and the eclipse flux
#   F = sum_l 0.5 (B_{l-1} + B_l)(Sbar_{l-1} - Sbar_l) + B_bot Sbar_bot
# with bin-center B is EXACTLY avg_k of the per-fine-point flux.


def fold_table(tab_fine, K):
    """[R, L, Wout*K] bin-major fine table -> [K, R, L, Wout]
    sub-sample-major layout (fine index f = b*K + k on the
    utils.grids.folded_fine_grid midpoint grid)."""
    R, L, WK = tab_fine.shape
    W = WK // K
    return jnp.transpose(tab_fine.reshape(R, L, W, K), (3, 0, 1, 2))


def _fold_mean(fn, tabk, out_like):
    """avg_k fn(tabk[k]) accumulated over the sub-sample axis one k at
    a time.  A bf16-stored table (fold_bf16) is widened per slice."""
    def step(acc, tab):
        return acc + fn(tab.astype(out_like.dtype)), None

    acc, _ = jax.lax.scan(step, jnp.zeros_like(out_like), tabk)
    return acc / tabk.shape[0]


def fused_eclipse_folded(tabk, wn_out, mu, muw, wrows, T, drp,
                         powers=False):
    """Eclipse flux F[wn_out] with rtosamp folding, one sample.  tabk
    [K, R, L, Wout] sub-sample-major fine table (``fold_table``);
    wn_out the OUTPUT bin centers; other arguments as fused_eclipse.
    ``powers=True`` requires the expsum quadrature."""
    R, L, W = tabk.shape[1:]

    def source(tab):                                           # [L, Wout]
        ext = jnp.einsum("lr,rlw->lw", wrows, tab,
                         precision=jax.lax.Precision.HIGHEST)
        seg = 0.5 * (ext[:-1] + ext[1:]) * drp[1:, None]
        tri = jnp.tril(jnp.ones((L - 1, L - 1), seg.dtype))
        tau = jax.lax.dot_general(
            tri, seg, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        tau = jnp.concatenate([jnp.zeros_like(tau[:1]), tau], axis=0)
        return _smix_jnp(tau, mu, muw, powers)

    sbar = _fold_mean(source, tabk, jnp.zeros((L, W), T.dtype))
    wn3 = _C1 * wn_out**3
    B = wn3[None, :] / (jnp.exp(const.C2 * wn_out[None, :] / T[:, None])
                        - 1.0)                                 # [L, Wout]
    Bmid = 0.5 * (B[:-1] + B[1:])
    flux = jnp.sum(Bmid * (sbar[:-1] - sbar[1:]), axis=0)
    return 2.0 * jnp.pi * (flux + B[-1] * sbar[-1])


def fused_transit_folded(tabk, wrows, G, wgt):
    """Annulus-integrated absorption out[wn_out] with rtosamp folding,
    one sample.  tabk [K, R, L, Wout] (``fold_table``); other
    arguments as fused_transit."""
    L, W = tabk.shape[2:]

    def absorption(tab):                                       # [L, Wout]
        ext = jnp.einsum("lr,rlw->lw", wrows, tab,
                         precision=jax.lax.Precision.HIGHEST)
        tau = jax.lax.dot_general(
            G, ext, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        return 1.0 - jnp.exp(-jnp.minimum(tau, TAU_CLAMP))

    abar = _fold_mean(absorption, tabk, jnp.zeros((L, W), wgt.dtype))
    return jnp.einsum("l,lw->w", wgt, abar,
                      precision=jax.lax.Precision.HIGHEST)

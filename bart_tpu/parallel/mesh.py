"""Device mesh and sharding layout for multi-chip retrievals.

Accelerator-native replacement for the reference's MPI topology (reference:
SURVEY.md section 2.5 — mpiexec + one process per chain, SHM-shared
opacity table): a 2-D ``(chain, wn)`` mesh where

* the **chain axis** shards the vmapped ensemble (replacing
  process-per-chain MPI entirely), and
* the **wn axis** shards every wavenumber-indexed table — opacity
  grid, wn grid, band matrix — replacing the POSIX-SHM opacity
  sharing with true distributed memory.

Because each output wavenumber is independent in the forward model
(lines were bucketed at table-build time), the runtime hot loop has
exactly ONE collective: the psum XLA inserts for the band-integration
matmul contraction over the sharded wn axis.  Everything else is
embarrassingly parallel — one small all-reduce per batch over NVLink
(every card reaches every other at the same rate, so the mesh shape
follows the algorithm alone).

Multi-host: initialize ``jax.distributed`` before calling make_mesh
and the same code spans hosts (the chain axis across hosts, wn
within one).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "table_shardings", "shard_tables", "shard_model"]


def make_mesh(n_chain: int = 1, n_wn: int | None = None, devices=None) -> Mesh:
    """Build a (chain, wn) mesh.  With ``n_wn=None`` all remaining
    devices go to the wn axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_wn is None:
        n_wn = len(devices) // n_chain
    if n_chain * n_wn != len(devices):
        devices = devices[: n_chain * n_wn]
    return Mesh(devices.reshape(n_chain, n_wn), ("chain", "wn"))


def table_shardings(mesh: Mesh) -> dict:
    """PartitionSpec per forward-model table key.

    Wavenumber-indexed arrays shard along 'wn'; small per-layer and
    quadrature arrays replicate.  CIA source tables replicate (they are
    interpolated onto the sharded wn grid locally).
    """
    def spec(*axes):
        return NamedSharding(mesh, P(*axes))

    rep = spec()
    out = {
        "wn": spec("wn"),
        "sigma": spec(None, None, None, "wn"),   # [mol, nT, layer, wn]
        "frows": spec(None, None, "wn"),         # [rows, layer, wn]
        # folded-rtosamp layouts (rt.fused): trailing axis is the
        # OUTPUT wn bin, so the same wn sharding applies
        "sigmak": spec(None, None, None, "wn"),  # [K, rows, layer, wn]
        "frowsk": spec(None, None, None, "wn"),
        "band_w": spec(None, "wn"),              # [nfilt, wn]
        "pressure": rep,
        "p_barye": rep,
        "base_q": rep,
        "h2he_ratio": rep,
        "masses": rep,
        "mu": rep,
        "mu_w": rep,
    }
    return out


def _lt_spec(mesh: Mesh) -> NamedSharding:
    """Line-tile arrays [n_tiles, ...]: the tile axis IS the wn axis
    (tile t covers grid slice [t*W, (t+1)*W)), so shard axis 0 along
    'wn'.  Lines whose wings cross a shard boundary were duplicated
    into both tiles at bucketing time (opacity.extinction.tile_lines),
    so no runtime halo exchange is needed."""
    return NamedSharding(mesh, P("wn", None))


def shard_tables(tables: dict, mesh: Mesh) -> dict:
    """device_put every table with its mesh sharding (CIA and unknown
    keys replicate)."""
    specs = table_shardings(mesh)
    rep = NamedSharding(mesh, P())
    lt = _lt_spec(mesh)
    return {
        k: jax.device_put(v, lt if k.startswith("lt") else specs.get(k, rep))
        for k, v in tables.items()
    }


def pad_tables_for_mesh(tables: dict, mesh: Mesh) -> dict:
    """Pad every wn-indexed table so the wn axis divides the mesh.

    The wn grid pads by repeating its endpoint (zero-width trapezoid
    segments -> no effect on integrals) and the band matrix pads with
    zeros (padded points carry no band weight), so sharded results are
    numerically identical to unsharded ones; the returned spectrum just
    carries trailing padded samples.
    """
    n_wn_shards = mesh.shape["wn"]
    out = dict(tables)
    lt_keys = sorted({k.split("_", 1)[0] for k in tables if k.startswith("lt")})

    if lt_keys:
        # On-the-fly mode: pad the TILE axis to divide the mesh, then
        # grow the working wn grid to exactly n_tiles * tile_size so
        # the per-tile cross-sections align with every wn-indexed
        # array shard-for-shard (padded tiles carry weight 0 and
        # padded wn points carry zero band weight).
        nt, W = tables[f"{lt_keys[0]}_wn_tiles"].shape
        for p in lt_keys[1:]:
            if tuple(tables[f"{p}_wn_tiles"].shape) != (nt, W):
                raise ValueError(
                    "sharded on-the-fly mode requires every species to "
                    "be tiled with the same wn grid and tile_size: "
                    f"{lt_keys[0]} has (nt, W)=({nt}, {W}) but {p} has "
                    f"{tuple(tables[f'{p}_wn_tiles'].shape)}"
                )
        nt_pad = (-nt) % n_wn_shards
        for p in lt_keys:
            for suf in ("wn0", "s296", "elower", "gamma_air", "n_air",
                        "weight"):
                a = tables[f"{p}_{suf}"]
                out[f"{p}_{suf}"] = jnp.pad(a, ((0, nt_pad), (0, 0)))
            wt = tables[f"{p}_wn_tiles"]
            out[f"{p}_wn_tiles"] = jnp.concatenate(
                [wt, jnp.broadcast_to(wt[-1:, -1:], (nt_pad, W))]
            ) if nt_pad else wt
            gm = tables[f"{p}_grid_mask"]
            out[f"{p}_grid_mask"] = jnp.pad(gm, ((0, nt_pad), (0, 0)))
        n_work = (nt + nt_pad) * W
        pad = n_work - tables["wn"].shape[0]
    else:
        nwave = tables["wn"].shape[0]
        pad = (-nwave) % n_wn_shards
        if pad == 0:
            return out
        if "sigma" in tables:
            out["sigma"] = jnp.pad(
                tables["sigma"], ((0, 0),) * 3 + ((0, pad),)
            )
        if "frows" in tables:
            out["frows"] = jnp.pad(
                tables["frows"], ((0, 0),) * 2 + ((0, pad),)
            )
        for k in ("sigmak", "frowsk"):
            if k in tables:
                out[k] = jnp.pad(
                    tables[k], ((0, 0),) * 3 + ((0, pad),)
                )

    if pad:
        out["wn"] = jnp.concatenate(
            [tables["wn"], jnp.repeat(tables["wn"][-1:], pad)]
        )
        out["band_w"] = jnp.pad(tables["band_w"], ((0, 0), (0, pad)))
    return out


def shard_model(fm, mesh: Mesh):
    """Re-home a ForwardModel's tables onto the mesh in place (padding
    the wn axis to divide the mesh if needed).

    After this, jitted calls that close over the model see committed
    sharded arrays and XLA partitions the forward model along wn
    automatically (band integration contracts over wn -> one psum).
    """
    if getattr(fm, "_idx_fine", None) is not None:
        raise ValueError(
            "wn-sharded execution requires a contiguous wn axis: build "
            "the ForwardModel with fold_adapt=None (config rtadapt = "
            "False) — the adaptive fine/smooth bin split permutes wn "
            "columns, which would turn the one-psum hot loop into "
            "gather/scatter collectives")
    fm.n_wn_orig = int(fm._tables["wn"].shape[0])
    fm._tables = shard_tables(pad_tables_for_mesh(fm._tables, mesh), mesh)
    fm._jitted = None
    return fm

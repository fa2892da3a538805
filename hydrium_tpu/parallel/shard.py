"""Sharded encode steps over a device mesh.

The JPEG XL group structure gives the parallel decomposition for free
(SURVEY.md section 2): 256x256 groups (and 2048x2048 LF groups) are
independent except for
  - per-preset histograms, shared across a frame -> psum over the mesh,
  - the host-side bitstream gather (variable-length, outside XLA).

Design: shard LF groups across a 1-D `groups` mesh axis with shard_map;
each device runs the full single-LFG pipeline (ops/pipeline.py) on its
local LFGs; per-preset histograms are summed with a psum so every host
can serialize any preset's header.  This mirrors data-parallel
batching, not a translation of any reference threading (the reference
has none: README.md:8).
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import pipeline, tables


def make_mesh(n_devices: int | None = None, axis: str = "groups",
              devices=None) -> Mesh:
    """A flat 1-D mesh over the first n_devices of `devices` (default:
    jax.devices()).  Every card reaches every other at the same rate
    (NVLink all-to-all), so the mesh follows the algorithm alone."""
    if devices is None:
        devices = jax.devices()
    devices = list(devices)[: n_devices or len(devices)]
    return Mesh(np.array(devices), (axis,))


def sharded_lfg_encode(mesh: Mesh, *, lfg_dim: int, linear_light: bool,
                       num_presets: int, sample_kind: str = "uint8"):
    """Build a jitted, shard_map'd function encoding a batch of LF groups.

    Returns fn(pixels [N, lfg_dim, lfg_dim, 3], presets [N]) -> dict with
    per-LFG serializer arrays plus globally-psummed per-cluster
    histograms.  N must be a multiple of the mesh size."""
    cluster_map = jnp.asarray(tables.hf_cluster_map(num_presets))
    num_clusters = int(tables.hf_cluster_map(num_presets).max()) + 1

    def one_lfg(pixels, preset):
        gc = max(lfg_dim >> 8, 1) ** 2
        buf = max(lfg_dim, 256)
        if pixels.shape[0] != buf:
            pixels = jnp.pad(pixels, ((0, buf - pixels.shape[0]),
                                      (0, buf - pixels.shape[1]), (0, 0)))
        return pipeline.encode_lfg(
            pixels, lfg_dim, lfg_dim,
            jnp.full((gc,), preset, jnp.int32), cluster_map,
            buf_h=buf, buf_w=buf, linear_light=linear_light,
            num_clusters=num_clusters, sample_kind=sample_kind,
            clusters_per_preset=num_clusters // num_presets)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("groups"), P("groups")),
        out_specs=(P("groups"), P()),
    )
    def step(pixels, presets):
        local = jax.vmap(one_lfg)(pixels, presets)
        hist = local.pop("hist")
        # per-preset histograms: clusters are disjoint across presets, so
        # a global psum combines every shard's counts without conflict.
        global_hist = jax.lax.psum(jnp.sum(hist, axis=0), "groups")
        return local, global_hist

    return jax.jit(step)

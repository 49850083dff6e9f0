"""Sharded classification step: shard_map + XLA collectives.

The communication design (SURVEY.md §2 parallelism table): per-read
candidate hits from every index shard are combined with an
``all_gather`` over the ``index`` axis (replacing the reference's
on-disk ``hits/<sample>_hits.pkl`` merge, `monica/genomes/
aligner.py:184-203,219-223`), and per-accession count tables are
reduced with ``psum`` over the ``index`` axis only — counts come back
PER DATA RANK (leading ``n_data`` axis), so a multi-host runtime can
read its own hosts' counts from its addressable shards without any
cross-host fetch; summing the axis gives the global table.
Collectives ride ICI; the host only sees final per-read results and
one small count block per batch.

Each device may hold SEVERAL index shards (when len(shards) >
mesh index-axis size): the index operand is a tuple of size-class
groups from :func:`pipeline.stack_mesh_shard_groups`, each stacked
rank-major, and the local step lax.maps over its local shards before
the all_gather — the device analog of the reference aligning every
read against every chunk (`aligner.py:91-103`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from monica_tpu.align import pipeline as pl
from monica_tpu.parallel.mesh import DATA_AXIS, INDEX_AXIS


def multihost_init(**kwargs) -> None:
    """Multi-host process-group bootstrap (jax.distributed). The
    reference has no distributed runtime at all (SURVEY.md §5); here
    this is one call and the mesh spans all hosts' devices.  Pass
    ``coordinator_address`` (host:port of process 0),
    ``num_processes`` and ``process_id`` (cli.py ``--coordinator``,
    ``--num_processes``, ``--process_id``); without them jax reads a
    cluster environment it can detect, or fails."""
    jax.distributed.initialize(**kwargs)


def make_sharded_classifier(
    mesh: Mesh,
    params: pl.ClassifyParams,
    n_accessions: int,
    count_mode: int = pl.MODE_QUERY_LENGTH,
    index_tree=None,
):
    """Build the jitted SPMD step: (index shard groups, read batch)
    -> (per-read merged results sharded over data,
        (n_data, n_accessions) counts sharded over data).

    ``index_tree``: the index operand (or any pytree of matching
    structure) — a single stacked :class:`pipeline.DeviceIndexShard`
    (one shard per index rank, the historical layout) or a tuple of
    rank-major stacked groups (several shards per rank).  Defaults to
    the single-group structure for backward compatibility.
    """

    def local_step(index, codes, lengths):
        # a bare DeviceIndexShard is a single group (it IS a tuple —
        # a NamedTuple — so the type check must be explicit)
        groups = (index,) if isinstance(index, pl.DeviceIndexShard) else index
        # block-local views: each group's leaves are (S_local_c, ...),
        # reads (B_local, L).  Sketching is shard-independent: hoist.
        sk = pl.sketch_batch(codes, lengths, params)
        hits = []
        for g in groups:
            s_local = g.mz_rows.shape[0]
            if s_local == 1:
                # 1-iteration lax.map pessimizes the XLA schedule
                # (dynamic-slices the index per step); squeeze instead
                h = pl.classify_shard(
                    jax.tree.map(lambda a: a[0], g), codes, lengths, params,
                    sketch=sk,
                )
                hits.append(jax.tree.map(lambda a: a[None], h))
            else:
                hits.append(
                    jax.lax.map(
                        lambda ix: pl.classify_shard(
                            ix, codes, lengths, params, sketch=sk
                        ),
                        g,
                    )
                )
        hit = (
            jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *hits)
            if len(hits) > 1
            else hits[0]
        )  # leaves (S_local, B_local)
        # every index shard scored this device's reads: gather all
        # ranks' hits for the local reads, then merge per read.
        gathered = jax.lax.all_gather(hit, INDEX_AXIS)  # (n_index, S_local, B)
        flat = jax.tree.map(
            lambda a: a.reshape((-1,) + a.shape[2:]), gathered
        )
        result = pl.merge_hits(flat, params.tie_rel_tol, params.vote_tie_sd)
        counts = pl.count_reads(result, lengths, n_accessions, count_mode)
        # every index-axis device computed the same merged result for
        # its reads; zero all but index rank 0 and psum over the index
        # axis only, so each data rank reports the counts of ITS OWN
        # rows — a multi-host runtime must be able to read per-host
        # counts from addressable shards (process_sample accumulates
        # per-sample tables host-side; a data-axis psum would mix
        # different hosts' samples into one column).
        keep = (jax.lax.axis_index(INDEX_AXIS) == 0).astype(counts.dtype)
        counts = jax.lax.psum(counts * keep, INDEX_AXIS)
        return result, counts[None]  # (1, n_acc) per data rank

    if index_tree is None:
        index_tree = pl.DeviceIndexShard(*[0] * len(pl.DeviceIndexShard._fields))
    index_in_spec = jax.tree.map(lambda _: P(INDEX_AXIS), index_tree)
    step = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(index_in_spec, P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=(
            jax.tree.map(lambda _: P(DATA_AXIS), pl.ReadResult(*[0] * 6)),
            P(DATA_AXIS),
        ),
        # all_gather over the index axis makes the merged result
        # mathematically identical on every index-axis device, but the
        # varying-mesh-axes inference cannot prove it; the index-axis
        # psum likewise replicates counts across index ranks.
        check_vma=False,
    )
    return jax.jit(step)

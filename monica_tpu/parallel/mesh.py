"""Device mesh construction and sharding specs.

The reference's parallelism is a thread pool over sample files plus
sequential alignment against every index chunk
(`monica/genomes/aligner.py:89-103`).  Here it is a 2-D mesh whose
shape follows the algorithm (every GPU of a host reaches every other
over NVLink at the same rate):

* ``data``  axis — read batches sharded across chips (the ThreadPool
  analog, but SPMD);
* ``index`` axis — reference-database shards across chips (the
  memory-bounded chunking analog, `monica/genomes/database.py:70-92`),
  merged with collectives instead of on-disk ``hits.pkl``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
INDEX_AXIS = "index"


def make_mesh(n_data: int | None = None, n_index: int = 1, devices=None) -> Mesh:
    """Create a ('data', 'index') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data is None:
        assert n % n_index == 0, f"{n} devices not divisible by index={n_index}"
        n_data = n // n_index
    if n_data * n_index != n:
        devices = devices[: n_data * n_index]
    dev = np.asarray(devices).reshape(n_data, n_index)
    return Mesh(dev, (DATA_AXIS, INDEX_AXIS))


def reads_spec() -> P:
    return P(DATA_AXIS)


def index_spec() -> P:
    """Stacked index shards: leading (shard) axis over the index axis."""
    return P(INDEX_AXIS)


def shard_reads(mesh: Mesh, codes, lengths):
    """Place a host read batch onto the mesh, sharded over data.

    Host-batch contract (multi-host): after ``jax.distributed``
    initialization the mesh spans every process's devices, and each
    process passes only its LOCAL rows here — the global batch is the
    process-order concatenation and every process must pass the same
    local shape (pad the last batch; the pipeline masks length-0 rows).
    DCN traffic is therefore zero on the feed path: each host's rows
    land on its own devices, and only the shard_map collectives
    (all_gather over ``index``, psum of the small count vector) cross
    hosts.  Single-process: pass the full batch."""
    s2 = NamedSharding(mesh, P(DATA_AXIS, None))
    s1 = NamedSharding(mesh, P(DATA_AXIS))
    if jax.process_count() > 1:
        codes = np.asarray(codes)
        lengths = np.asarray(lengths)
        gb = codes.shape[0] * jax.process_count()
        return (
            jax.make_array_from_process_local_data(s2, codes, (gb, codes.shape[1])),
            jax.make_array_from_process_local_data(s1, lengths, (gb,)),
        )
    return jax.device_put(codes, s2), jax.device_put(lengths, s1)


def fetch_local_rows(arr) -> np.ndarray:
    """Host fetch of THIS process's rows of a data-sharded global array
    (multi-host runtime: the global result of the sharded step is not
    fully addressable, but each process fed — and owns — its own rows,
    `shard_reads`'s host-batch contract).  Index-axis replicas hold
    identical copies of the same row range; dedupe by range and
    concatenate in global row order."""
    seen: dict[int, np.ndarray] = {}
    for s in arr.addressable_shards:
        start = s.index[0].start or 0
        if start not in seen:
            seen[start] = np.asarray(s.data)
    return np.concatenate([seen[k] for k in sorted(seen)], axis=0)


def shard_index(mesh: Mesh, stacked_index):
    """Place stacked DeviceIndexShard arrays with the leading shard axis
    over the index mesh axis."""
    return jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P(INDEX_AXIS, *([None] * (a.ndim - 1))))),
        stacked_index,
    )

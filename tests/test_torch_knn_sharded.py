"""Port parity: the kNN over a cloud split across processes
(`mvtracker_torch/ops/knn.py::knn_sharded`, `knn_sharded_ring`) on 4 gloo
CPU processes, against the JAX schedules on a 4-device CPU mesh and against
one search of the whole cloud.

The port merges candidates by the key (distance, global index), so both
schedules equal the exact global search (lower index first among equal
distances) in distances and indices, ties included. JAX's gather-merge
keeps the shards' order, which is the same thing; JAX's ring puts the
running best before the visiting shard, an order that depends on the
device, so with ties across shards it can order tied indices otherwise
(ROADMAP C.5): the case with ties checks that this is the only difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mvtracker_torch.ops import knn as t_knn
from mvtracker_tpu.ops import knn as j_knn
from tests import torch_dist

WORLD, K = 4, 8


def _random(seed, b=1, n=512, m=40):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, 3)).astype(np.float32), rng.normal(size=(b, m, 3)).astype(np.float32)


def _tied(seed):
    """Every shard holds the same points, so each neighbour has a twin at
    the same distance in each of the 4 shards."""
    ref, query = _random(seed, n=128)
    return np.concatenate([ref] * WORLD, axis=1), query


CASES = {
    "gather": (*_random(0), "gather", "exact"),
    "ring": (*_random(0), "ring", "exact"),
    "gather_auto": (*_random(1, b=2, m=24), "gather", "auto"),
    "ring_auto": (*_random(1, b=2, m=24), "ring", "auto"),
    "gather_ties": (*_tied(2), "gather", "exact"),
    "ring_ties": (*_tied(2), "ring", "exact"),
}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """All cases in one run of 4 processes; rank -> list of (dists, idx)."""
    cases = [(ref, query, K, schedule, backend) for ref, query, schedule, backend in CASES.values()]
    per_rank = torch_dist.spawn(torch_dist.knn_cases, WORLD, tmp_path_factory.mktemp("knn"), cases)
    return {name: [per_rank[r][i] for r in range(WORLD)] for i, name in enumerate(CASES)}


def _jax_sharded(ref, query, schedule):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("cloud",))
    fn = {"gather": j_knn.knn_sharded, "ring": j_knn.knn_sharded_ring}[schedule]
    f = shard_map(lambda r, q: fn(r, q, K, "cloud", backend="xla"), mesh=mesh,
                  in_specs=(P(None, "cloud", None), P(None, None, None)),
                  out_specs=(P(None, None, None), P(None, None, None)), check_vma=False)
    d, i = f(jnp.asarray(ref), jnp.asarray(query))
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedules_equal_the_global_search(port_results, name):
    """Every rank gets the same bits, equal to the exact search of the whole
    cloud: distances bit for bit, indices one for one, ties included."""
    ref, query, _, backend = CASES[name]
    want_d, want_i = t_knn.knn_exact_plain(torch.from_numpy(ref), torch.from_numpy(query), K)
    for d, i in port_results[name]:
        np.testing.assert_array_equal(d, want_d.numpy())
        np.testing.assert_array_equal(i, want_i.numpy())
    if name.endswith("_ties"):
        assert (np.diff(want_d.numpy(), axis=-1) == 0).mean() > 0.5  # the case has ties in most rank pairs


@pytest.mark.parametrize("name", ["gather", "ring", "gather_ties"])
def test_schedules_match_jax(port_results, name):
    """Against the JAX schedule on the same shards: distances to fp32
    rounding (JAX's search expands |q - r|^2 into a matmul), indices exactly."""
    ref, query, schedule, _ = CASES[name]
    j_d, j_i = _jax_sharded(ref, query, schedule)
    d, i = port_results[name][0]
    np.testing.assert_allclose(d, j_d, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(i, j_i)


def test_ring_tie_order_departs_from_jax_only_within_ties(port_results):
    """JAX's ring orders tied indices by the device's visiting order, the
    port by index: the same distances and, per row, the same neighbours
    within each run of equal distances; the order of some ties differs."""
    ref, query, schedule, _ = CASES["ring_ties"]
    j_d, j_i = _jax_sharded(ref, query, schedule)
    d, i = port_results["ring_ties"][0]
    np.testing.assert_allclose(d, j_d, rtol=0, atol=1e-5)
    reordered = 0
    for row in np.ndindex(d.shape[:-1]):
        # Ties by the port's distances (JAX's may differ in the last bit).
        groups = np.split(np.arange(K), np.flatnonzero(np.diff(d[row])) + 1)
        for g in groups[:-1]:  # the last run may be cut by k on either side
            assert sorted(i[row][g]) == sorted(j_i[row][g]), row
        reordered += int((i[row] != j_i[row]).any())
    assert reordered > 0  # the data does exercise the departure

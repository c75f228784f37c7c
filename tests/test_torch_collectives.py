"""The port's collectives (``dist/collectives.py``) and rank spawner
(``launch/mesh.py``) on gloo ranks on the CPU, against the JAX
package's ``tp_allreduce`` on the 8 virtual devices of ``conftest.py``.

One group of 4 ranks runs every collective check (``torch_tp_ranks.
collectives_suite``); the bound of the compressed sum is the one in the
docstring of ``test_collectives.py::test_compressed_psum_error_bound_
property``: ``shards * amax / 127 * 1.5``. Every spawn has a deadline
that kills its ranks, so a hung collective fails its test in seconds.
"""
import multiprocessing
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_tp_ranks as R
from repro.dist.collectives import shard_map
from repro.dist.collectives import tp_allreduce as jtp_allreduce
from repro.launch.mesh import make_tp_mesh as jmake_tp_mesh
from repro_torch.dist.sharding import replica_device_groups
from repro_torch.launch.mesh import TPMesh, make_tp_mesh, spawn_tp
from torch_threads import one_thread  # noqa: F401

SHARDS = 4
SWEEP = tuple((seed, scale, shape) for seed, (scale, shape) in enumerate(
    [(1.0, (16,)), (1e-3, (8, 8)), (50.0, (33,)), (1.0, (2, 3, 5)), (7.5, (128,)),
     (1e-6, (4,)), (3.0, (64, 2)), (0.25, (1,))]))
TRIALS = 400


@pytest.fixture(scope="module")
def suite():
    return spawn_tp(R.collectives_suite, SHARDS, SWEEP, TRIALS, timeout=180.0,
                    threads=1)


def test_compressed_sum_within_bound_over_a_seeded_sweep(suite):
    for (shards_x, got), (seed, _, shape) in zip(suite["sweep"], SWEEP):
        want = shards_x.astype(np.float64).sum(axis=0)
        amax = np.abs(shards_x).max()
        bound = SHARDS * max(amax, 1e-12) / 127.0 * 1.5
        assert got.shape == shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= bound, (seed, shape)


def test_compressed_sum_unbiased_across_fresh_generators(suite):
    """The mean over 400 fresh rounding streams approaches the exact sum:
    a stochastic rounding error is zero-mean with a variance of at most
    step**2 / 4 per shard, so the mean's error stays within 4 of its
    standard errors, 4 * step * sqrt(shards / 4 / trials)."""
    shards_x, mean = suite["unbiased"]
    want = shards_x.astype(np.float64).sum(axis=0)
    step = np.abs(shards_x).max() / 127.0
    assert np.abs(mean - want).max() <= 4 * step * np.sqrt(SHARDS / 4 / TRIALS)


def test_compressed_sum_of_integer_partials_unbiased_and_streams_per_rank(suite):
    """The reference's properties of the collective on fixed integer
    partials (the CiM event counts a row-parallel layer sums): the mean
    over 256 fresh generators lies within 4 standard errors of the exact
    sum, 4 * step * sqrt(shards / 4 / trials); and the default rounding
    stream of ``execute_tp`` differs between ranks (each rank rounds
    with noise of its own), while it is one stream per (shape, rank)."""
    shards_x, mean = suite["unbiased_int"]
    assert np.array_equal(shards_x, np.round(shards_x))
    want = shards_x.astype(np.float64).sum(axis=0)
    step = np.abs(shards_x).max() / 127.0
    assert np.abs(mean - want).max() <= 4 * step * np.sqrt(SHARDS / 4 / R.INT_TRIALS)
    assert not np.array_equal(mean, want)
    draws = suite["default_streams"]
    assert draws.shape == (SHARDS, 32)
    assert all(not np.array_equal(draws[i], draws[j])
               for i in range(SHARDS) for j in range(i + 1, SHARDS))


def test_exact_sum_matches_reference_tp_allreduce(suite):
    """The exact path, on integer counts as the CiM partials are: the
    port's sum == the reference's psum inside shard_map, bit for bit."""
    shards_x, got = suite["exact"]
    mesh = jmake_tp_mesh(SHARDS)
    f = shard_map(lambda a: jtp_allreduce(a[0], "model"), mesh=mesh,
                  in_specs=P("model"), out_specs=P())
    want = np.asarray(f(jnp.asarray(shards_x)))
    np.testing.assert_array_equal(got, want)
    assert suite["counted"] == {"all_gather": 1, "all_reduce": 1}


def test_max_gather_and_raise_without_generator(suite):
    np.testing.assert_array_equal(suite["max"], [SHARDS - 1])
    want = np.concatenate([
        np.asarray(jnp.asarray(np.arange(6, dtype=np.float32) + 0.1 * r, jnp.bfloat16),
                   np.float32) for r in range(SHARDS)])
    np.testing.assert_array_equal(suite["gather_bf16"][0], want)
    assert "Generator" in suite["no_generator"]


def test_mean_grads_int8(suite):
    shards_g, got = suite["mean_grads"]
    want = shards_g.astype(np.float64).mean(axis=0)
    bound = np.abs(shards_g).max() / 127.0 * 1.5
    assert np.abs(got - want).max() <= bound


def test_replica_meshes_are_the_rows_of_the_grid(suite):
    """make_replica_meshes(2, 2) on 4 ranks: rank 0 is rank 0 of the
    first row and in no other; a sum over its row adds ranks 0 and 1."""
    meshes, row_sum = suite["replicas"]
    assert meshes == [(0, (0, 1)), (-1, (2, 3))]
    np.testing.assert_array_equal(row_sum, [1.0])
    groups = replica_device_groups(2, 2, devices=list("abcd"))
    assert groups == [["a", "b"], ["c", "d"]]
    with pytest.raises(ValueError, match="needs 6 devices"):
        replica_device_groups(3, 2, devices=list("abcd"))


def test_spawn_returns_rank0_result_as_numpy(suite):
    assert suite["mesh"] == (0, (0, 1, 2, 3), {"data": 1, "model": SHARDS})
    assert all(isinstance(got, np.ndarray) for _, got in suite["sweep"])


def test_spawn_fails_when_a_rank_raises():
    """Rank 1 raises while rank 0 waits in a collective: the parent kills
    rank 0 and reports rank 1's traceback, long before the deadline."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_tp(R.raise_on_rank_1, 2, timeout=120.0, threads=1)


def test_spawn_kills_ranks_past_the_deadline():
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn_tp(R.hang, 2, 600.0, timeout=5.0, threads=1)


def test_mesh_guards():
    with pytest.raises(ValueError, match="tp must be"):
        make_tp_mesh(0)
    mesh = TPMesh(None, 1, 3, (0, 1, 2))
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 3}


def test_build_lock_builds_each_source_once(tmp_path):
    """Three processes build the kernels at once (as a TP group's ranks
    would): the build lock lets one compile each source, the others find
    the libraries. The compiler here is a stand-in that logs its calls."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {calls}\n"
                    "sleep 0.5\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(3) as pool:
        built = pool.starmap(R.build_with, [(str(tmp_path / "build"), str(nvcc))] * 3)
    assert built[0] == built[1] == built[2] == ["packed_mac", "packed_stream",
                                                "ternary_exact", "ternary_mac"]
    assert len(calls.read_text().splitlines()) == 4
    assert sorted(os.listdir(tmp_path / "build"))[0] == "build.lock"

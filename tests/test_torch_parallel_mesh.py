"""The port's data axis (``arvae_tpu_torch/parallel``) and its row-sharded
splits against the JAX package's mesh and ``DeviceSplit``.

- The four batch helpers and ``masked_mean`` are rank arithmetic: for
  each rank of a W-rank ``DataContext`` (no process group needed) the
  port's rows equal bitwise the shard JAX's helper puts on device k of a
  W-device mesh (tests/conftest.py's 8 CPU devices), with the same
  raises, zero padding and mask, and ``None`` for a batch truncated to
  no rows. ``DataContext.share`` gives rank k the rows of JAX's shard k
  of a batch padded to the data axis, the padding dropped.
- ``DeviceSplit.gather_batch`` on W ∈ {2, 4} spawned gloo ranks
  (``tests/torch_parallel_ranks.py``): for the ``packed``, ``bytes`` and
  ``tokens`` kinds, at B = 5, 12, 13 (as
  ``tests/test_device_data_sharded.py``) and 32, the row-sharded split
  (⌈N/W⌉ rows a rank) gives each rank bitwise the rows the replicated
  split gives it, their concatenation is bitwise JAX's row-sharded
  ``gather_batch`` on its mesh, and a rank left with no row (B=5 at W=4)
  holds the batch's last row. ``masked_mean`` over padded shards on the
  ranks equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from arvae_tpu.data.device_data import DeviceSplit as JaxSplit
from arvae_tpu.parallel import create_mesh
from arvae_tpu.parallel import masked_mean as jax_masked_mean
from arvae_tpu.parallel import shard_batch as jax_shard_batch
from arvae_tpu.parallel import shard_batch_padded as jax_shard_batch_padded
from arvae_tpu.parallel import shard_batch_truncated as jax_shard_batch_truncated
from arvae_tpu_torch.parallel import (DataContext, init_data_parallel, masked_mean,
                                      shard_batch, shard_batch_padded, shard_batch_truncated)

WORLDS = (2, 4, 8)
N, D, L = 1003, 64, 3  # N divides none of the worlds
GATHER_BATCHES = (5, 12, 13, 32)
GATHER_WORLDS = (2, 4)


def _mesh(world):
    return create_mesh(devices=jax.devices()[:world])


def _shard(arr, k):
    """Device k's shard of a JAX array sharded over a 1-D data mesh."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
    return np.asarray(shards[k].data)


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 3).astype(np.float32),
            "y": rng.randint(0, 9, (n, 2)).astype(np.int32)}


@pytest.mark.parametrize("world", WORLDS)
def test_shard_batch_is_jax_shard(world):
    batch = _batch(16)
    want = jax_shard_batch(_mesh(world), batch)
    for k in range(world):
        got = shard_batch(DataContext(world, k), batch)
        for name in batch:
            np.testing.assert_array_equal(got[name].numpy(), _shard(want[name], k))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_batch_raises_on_uneven_as_jax(world):
    x = np.arange(10 * world + 1, dtype=np.float32).reshape(-1, 1)
    with pytest.raises(ValueError, match="does not divide"):
        jax_shard_batch(_mesh(world), x)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(DataContext(world, 0), x)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", [13, 16, 3])
def test_shard_batch_padded_is_jax_shard(world, n):
    batch = (_batch(n)["x"], _batch(n)["y"])
    want, want_mask = jax_shard_batch_padded(_mesh(world), batch)
    for k in range(world):
        got, mask = shard_batch_padded(DataContext(world, k), batch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _shard(w, k))
        np.testing.assert_array_equal(mask.numpy(), _shard(want_mask, k))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", [13, 16, 3])
def test_shard_batch_truncated_is_jax_shard(world, n):
    batch = _batch(n)
    want = jax_shard_batch_truncated(_mesh(world), batch)
    for k in range(world):
        got = shard_batch_truncated(DataContext(world, k), batch)
        if want is None:
            assert got is None
            continue
        for name in batch:
            np.testing.assert_array_equal(got[name].numpy(), _shard(want[name], k))


def test_inconsistent_leading_dims_raise():
    with pytest.raises(ValueError, match="inconsistent leading dims"):
        shard_batch_padded(DataContext(2, 0), (np.zeros(4), np.zeros(5)))


def test_masked_mean_on_one_rank_is_jax():
    x = np.random.RandomState(1).randn(13, 4).astype(np.float32)
    (xp,), mask = jax_shard_batch_padded(_mesh(8), (x,))
    want = float(jax.jit(jax_masked_mean)(xp, mask))
    (v,), m = shard_batch_padded(DataContext(), (x,))
    np.testing.assert_allclose(float(masked_mean(v, m)), want, rtol=1e-6)
    np.testing.assert_allclose(want, float(x.mean()), rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("b", [1, 5, 12, 13, 16, 18])
def test_share_is_jax_padded_shard_without_padding(world, b):
    """Rank k's rows: JAX's shard k of the batch padded to the data axis
    (``device_data.py``'s nondivisible gather), the padding dropped."""
    rows = np.arange(b)
    (padded,), mask = jax_shard_batch_padded(_mesh(world), (rows,))
    covered = []
    for k in range(world):
        share = DataContext(world, k).share(b)
        real = _shard(padded, k)[_shard(mask, k) == 1]
        np.testing.assert_array_equal(np.arange(share.start, share.stop), real)
        covered.extend(range(share.start, share.stop))
        assert share.rows == max(share.n, 1)
        assert share.first == (share.start if share.n else b - 1)
    assert covered == list(range(b))


def test_world_of_one_without_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    ctx = init_data_parallel("cpu")
    assert (ctx.n_data, ctx.rank, ctx.group, ctx.distributed) == (1, 0, None, False)
    assert ctx.device == torch.device("cpu") and ctx.is_main
    share = ctx.share(7)
    assert (share.start, share.stop, share.total) == (0, 7, 7)


def test_a_world_size_without_a_rank_raises(monkeypatch):
    for var in ("RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="without a rank"):
        init_data_parallel("cpu")


# ---------------------------------------------------------------------------
# Row-sharded splits on gloo ranks
# ---------------------------------------------------------------------------


def _split_data():
    rng = np.random.RandomState(7)
    rows = rng.randint(0, 256, (N, D)).astype(np.uint8)
    labels = rng.randn(N, L).astype(np.float32)
    return {"packed": (rows, labels, (D * 8,)), "bytes": (rows, labels, (D,)),
            "tokens": (rows.astype(np.int32), None, (D,))}


def _batch_idx():
    rng = np.random.RandomState(1)
    return [rng.permutation(N)[:b].astype(np.int64) for b in GATHER_BATCHES]


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    """W → every rank's ``gather_body`` results."""
    root = tmp_path_factory.mktemp("parallel_gather")
    values = np.random.RandomState(5).randn(13, 4).astype(np.float32)
    memo = {}

    def get(world):
        if world not in memo:
            workdir = root / f"w{world}"
            workdir.mkdir()
            torch.save({"splits": _split_data(), "idx": _batch_idx(), "values": values},
                       workdir / "gather.pt")
            memo[world] = ranks.run_ranks(world, "gather_body", str(workdir))
        return memo[world]

    return get, values


@pytest.mark.parametrize("world", GATHER_WORLDS)
@pytest.mark.parametrize("kind", ["packed", "bytes", "tokens"])
def test_row_sharded_gather_is_the_replicated_one(gathered, world, kind):
    get, _ = gathered
    for rank, res in enumerate(get(world)):
        assert res[kind]["row_sharded"]
        assert res[kind]["local_rows"] == -(-N // world)
        for (got, want, _, _), b in zip(res[kind]["batches"], GATHER_BATCHES):
            for g, w in zip(got, want):
                assert torch.equal(g, w), f"rank {rank} B={b}"


def _jax_rows(jsplit, idx, world):
    """JAX's row-sharded gather itself (``_sharded_take``, jitted), the
    index padded to the data axis with its last as ``gather_batch`` pads it,
    then cut to B: the rows before ``gather_batch`` casts them."""
    b = len(idx)
    pad = -b % world
    idx_p = np.concatenate([idx, np.repeat(idx[-1:], pad)]).astype(np.int32)
    rows, labs = jax.jit(jsplit._sharded_take)(jsplit.images, jsplit.labels,
                                               jnp.asarray(idx_p))
    return np.asarray(rows)[:b], np.asarray(labs)[:b]


@pytest.mark.parametrize("world", GATHER_WORLDS)
@pytest.mark.parametrize("kind", ["packed", "bytes", "tokens"])
def test_row_sharded_gather_is_jax_bitwise(gathered, world, kind):
    """The ranks' real rows, concatenated, against JAX's jitted
    ``gather_batch`` on its row-sharded split; for ``bytes`` the images
    against JAX's gathered rows divided by 255, as both packages write it
    (under jit XLA turns that division into a product with the
    reciprocal, one rounding off)."""
    get, _ = gathered
    rows, labels, shape = _split_data()[kind]
    ctx = _mesh(world)
    jax_labels = rows if kind == "tokens" else labels
    jsplit = JaxSplit(rows, jax_labels, shape, kind, ctx, row_sharded=True)
    results = get(world)
    for j, idx in enumerate(_batch_idx()):
        want = [np.asarray(x) for x in jax.jit(jsplit.gather_batch)(
            jsplit.images, jsplit.labels, jnp.asarray(idx.astype(np.int32)))]
        if kind == "bytes":
            want[0] = (_jax_rows(jsplit, idx, world)[0].astype(np.float32)
                       / np.float32(255.0)).reshape(want[0].shape)
        for part in range(2):
            real = [res[kind]["batches"][j][0][part][:stop - start]
                    for res in results
                    for start, stop in [res[kind]["batches"][j][2:]]]
            np.testing.assert_array_equal(torch.cat(real).numpy(), want[part],
                                          err_msg=f"B={len(idx)} part {part}")


def test_a_rank_with_no_rows_holds_the_last_row(gathered):
    get, _ = gathered
    rows = _split_data()["bytes"][0]
    idx = _batch_idx()[0]  # B=5 at W=4: 2, 2, 1, 0 rows
    last = get(4)[3]["bytes"]["batches"][0]
    start, stop = last[2:]
    assert start == stop == 5
    np.testing.assert_array_equal(last[0][0].numpy().reshape(1, -1),
                                  rows[idx[-1:]].astype(np.float32) / np.float32(255.0))


@pytest.mark.parametrize("world", GATHER_WORLDS)
def test_masked_mean_over_ranks_is_jax(gathered, world):
    get, values = gathered
    (xp,), mask = jax_shard_batch_padded(_mesh(world), (values,))
    want = float(jax.jit(jax_masked_mean)(xp, mask))
    for res in get(world):
        np.testing.assert_allclose(res["masked_mean"], want, rtol=1e-6)

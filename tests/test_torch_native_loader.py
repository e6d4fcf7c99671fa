"""The port's ``.seldpak`` reader, its loaders and the streamed normalization
against the JAX package's, on the CPU.

- container files cross-read in both directions, and the two writers write
  the same bytes (``write_pak``, ``pack_dataset``);
- the C++ gather (``seldio_gather_rows``, built by g++ into
  ``seld_tpu_torch/_build/``) equals its numpy plain version and the JAX
  ``PakReader.gather``; a failed build, a foreign or truncated file and a row
  out of range raise;
- ``PakBatchIterator`` and the sharded ``BatchIterator`` equal the JAX ones
  batch for batch at ``num_shards`` 1 and 2, with remainders that split and
  that do not, and ``drop_last``;
- ``compute_norm_stats`` / ``make_batch_transform`` equal the JAX ones in the
  normalization of every shipped config, UnitNorm and off;
- ``load_task2_pickles`` reads a ``.seldpak`` as the JAX one does.
"""

from pathlib import Path

import numpy as np
import pytest

from seld_tpu.data import loader as jax_loader
from seld_tpu.data import native as jax_native
from seld_tpu.data import normalize as jax_normalize
from seld_tpu_torch.config import SELDConfig, load_config
from seld_tpu_torch.data import loader, native, normalize
from seld_tpu_torch.data.synthetic import gen_fake_task2_dataset

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "config").glob("*.txt"))


def _tensors(rng):
    return [rng.standard_normal((7, 3, 4)).astype(np.float32),
            rng.standard_normal((5,)).astype(np.float32),
            rng.standard_normal((2, 1, 3, 2, 2)).astype(np.float32),
            np.zeros((0, 4), np.float32)]


def test_the_library_builds_into_the_ports_build_directory():
    path = native.build_library()
    assert path.parent == ROOT / "seld_tpu_torch" / "_build" and path.is_file()
    assert native.build_library() == path   # built once a source


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_a_failed_build_raises(cxx):
    with pytest.raises(RuntimeError, match="could not run|failed"):
        native.build_library(cxx)


def test_files_cross_read_and_the_writers_agree(tmp_path, rng):
    tensors = _tensors(rng)
    ours, theirs = str(tmp_path / "port.seldpak"), str(tmp_path / "jax.seldpak")
    native.write_pak(ours, tensors)
    jax_native.write_pak(theirs, tensors)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    for path in (ours, theirs):
        with native.PakReader(path) as port:
            jax = jax_native.PakReader(path)
            assert port.num_tensors() == jax.num_tensors() == len(tensors)
            for i, t in enumerate(tensors):
                assert port.shape(i) == jax.shape(i) == t.shape
                np.testing.assert_array_equal(port.tensor(i), t)
                np.testing.assert_array_equal(jax.tensor(i), t)
            jax.close()


def test_the_cpp_gather_equals_numpy_and_the_jax_reader(tmp_path, rng):
    t = rng.standard_normal((20, 6, 3)).astype(np.float32)
    path = str(tmp_path / "g.seldpak")
    jax_native.write_pak(path, [t, t[:, 0]])
    idx = np.array([3, 0, 19, 7, 7], dtype=np.int64)
    jax = jax_native.PakReader(path)
    with native.PakReader(path) as reader:
        for i in (0, 1):
            got = reader.gather(i, idx)
            np.testing.assert_array_equal(got, reader.gather_plain(i, idx))
            np.testing.assert_array_equal(got, jax.gather(i, idx))
            np.testing.assert_array_equal(got, [t, t[:, 0]][i][idx])
            assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
        assert reader.gather(0, idx[:0]).shape == (0, 6, 3)
        with pytest.raises(IndexError):
            reader.gather(0, np.array([20]))
        with pytest.raises(IndexError):
            reader.gather(0, np.array([-1]))
        with pytest.raises(IndexError):
            reader.shape(2)
    jax.close()


def test_foreign_and_truncated_files_raise(tmp_path, rng):
    with pytest.raises(FileNotFoundError, match="seldpak"):
        native.PakReader(str(tmp_path / "none.seldpak"))
    path = tmp_path / "t.seldpak"
    native.write_pak(str(path), _tensors(rng))
    whole = path.read_bytes()
    for bad in (b"NOTAPAK1" + whole[8:], whole[:40], whole[:-8]):
        path.write_bytes(bad)
        with pytest.raises(ValueError, match="seldpak"):
            native.PakReader(str(path))


def _set(rng, n_train, n_val=5, n_test=3):
    """A tiny six-tensor set: (predictors, targets) dicts and its .seldpak."""
    x = {s: rng.standard_normal((n, 8, 4, 5)).astype(np.float32) * 3 + 1
         for s, n in (("train", n_train), ("val", n_val), ("test", n_test))}
    y = {s: rng.standard_normal((len(v), 2, 6)).astype(np.float32) for s, v in x.items()}
    return x, y


@pytest.mark.parametrize("n_train,batch", [(11, 4), (10, 4), (8, 4)],
                         ids=["remainder_3", "remainder_2", "no_remainder"])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_loaders_equal_the_jax_loaders_batch_for_batch(tmp_path, rng, n_train, batch,
                                                       num_shards):
    x, y = _set(rng, n_train)
    path = str(tmp_path / "d.seldpak")
    native.write_pak(path, [a for s in ("train", "val", "test") for a in (x[s], y[s])])
    jax = jax_native.PakReader(path)
    with native.PakReader(path) as reader:
        for shard_id in range(num_shards):
            shard = dict(num_shards=num_shards, shard_id=shard_id)
            pairs = [(loader.make_loaders(x, y, batch, seed=1, **shard),
                      jax_loader.make_loaders(x, y, batch, seed=1, **shard)),
                     (loader.make_pak_loaders(reader, batch, seed=1, **shard),
                      jax_loader.make_pak_loaders(jax, batch, seed=1, **shard))]
            for got, want in pairs:
                for split in ("train", "val", "test"):
                    for drop_last in (False, True):
                        got[split].drop_last = want[split].drop_last = drop_last
                        for epoch in (1, 2):
                            got[split].set_epoch(epoch)
                            want[split].set_epoch(epoch)
                            assert len(got[split]) == len(want[split])
                            n = 0
                            for (gx, gy), (wx, wy) in zip(got[split], want[split],
                                                          strict=True):
                                np.testing.assert_array_equal(gx, wx)
                                np.testing.assert_array_equal(gy, wy)
                                n += 1
                            assert n == len(got[split])
    jax.close()


def test_shards_cover_each_global_batch_once(rng):
    x, y = _set(rng, 10)
    order = np.arange(10)
    np.random.default_rng(1 + 3).shuffle(order)
    shards = [loader.BatchIterator(x["train"], np.arange(10), 4, shuffle=True, seed=1,
                                   num_shards=2, shard_id=i) for i in range(2)]
    for s in shards:
        s.set_epoch(3)
    rows = [np.concatenate([a, b]) for (_, a), (_, b) in zip(*shards, strict=True)]
    np.testing.assert_array_equal(np.concatenate(rows), order)
    with pytest.raises(ValueError, match="split"):
        loader.BatchIterator(x["train"], y["train"], 3, num_shards=2)


def _norm_cases():
    for path in CONFIGS:
        cfg = load_config(str(path))
        yield pytest.param(dict(mode=cfg.dataset_normalization, n_mics=cfg.n_mics,
                                phase=cfg.phase, domain=cfg.domain), id=path.stem)
    yield pytest.param(dict(mode="UnitNorm", n_mics=2, domain="DQ"), id="unitnorm")
    yield pytest.param(dict(mode="False"), id="off")


@pytest.mark.parametrize("kw", list(_norm_cases()))
def test_streamed_normalization_equals_the_jax_package(tmp_path, rng, kw):
    channels = 16 if kw.get("phase") else 8
    x = (rng.standard_normal((37, channels, 4, 5)) * 2 + 0.5).astype(np.float32)
    path = str(tmp_path / "n.seldpak")
    native.write_pak(path, [x])
    with native.PakReader(path) as reader:
        view = reader.tensor(0)
        got = normalize.compute_norm_stats(view, **kw)
        want = jax_normalize.compute_norm_stats(view, **kw)
        assert got == want
        fn = normalize.make_batch_transform(stats=got, **kw)
        jfn = jax_normalize.make_batch_transform(stats=want, **kw)
        batch = reader.gather(0, np.array([5, 1, 30]))
        np.testing.assert_array_equal(fn(batch), jfn(batch))
    # the per-batch path normalizes as the whole split is normalized
    whole = normalize.normalize_dataset({"train": x}, **kw)["train"]
    np.testing.assert_allclose(fn(x), whole, rtol=0, atol=1e-5 * np.abs(whole).max())


def test_load_task2_pickles_reads_a_seldpak_as_the_jax_package(tmp_path):
    paths = gen_fake_task2_dataset(str(tmp_path / "data"), n_train=3, n_val=2, n_test=1,
                                   channels=4, freq=8, time_frames=6, label_frames=2)
    cfg = SELDConfig(training_predictors_path=paths["train"][0],
                     training_target_path=paths["train"][1],
                     validation_predictors_path=paths["validation"][0],
                     validation_target_path=paths["validation"][1],
                     test_predictors_path=paths["test"][0], test_target_path=paths["test"][1])
    ours = native.pack_dataset(cfg, str(tmp_path / "port.seldpak"))
    theirs = jax_native.pack_dataset(cfg, str(tmp_path / "jax.seldpak"))
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    pickled = loader.load_task2_pickles(cfg)
    got = loader.load_task2_pickles(cfg.replace(training_predictors_path=ours))
    want = jax_loader.load_task2_pickles(cfg.replace(training_predictors_path=ours))
    for g, w, p in zip(got, want, pickled):
        for split in ("train", "val", "test"):
            np.testing.assert_array_equal(g[split], w[split])
            np.testing.assert_array_equal(g[split], np.asarray(p[split], np.float32))

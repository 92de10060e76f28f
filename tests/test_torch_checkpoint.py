"""The port's checkpoint store, alone and against the JAX package's.

The store's load-bearing properties, as tests/test_checkpoint.py holds
them for the JAX package, on torch leaves: bitwise round trips of nested
trees, loud failure on structure, shape and dtype mismatches, CRC
detection of bit-rot, atomic writes that never leave a partial file
under the final name, and step selection that skips damaged files.

Across packages: both write the same format (``np.savez``, a v2
manifest of key paths, dtypes and CRC32s), and the port walks dict keys
sorted as JAX does, so for one tree of plain dicts, lists, tuples and
NamedTuples the two manifests are equal, a file either package writes
verifies and restores in the other with equal leaves, and both reject a
v2 file with one flipped byte or a truncated one.
"""
import json
import os
import typing
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CorruptCheckpointError,
    latest_step,
    restore_latest,
    restore_pytree,
    restore_step,
    save_pytree,
    save_step,
    valid_steps,
    verify_checkpoint,
)
from repro_torch.checkpoint.checkpoint import (  # noqa: E402
    _flatten_with_paths)


class Carry(typing.NamedTuple):
    x: dict
    y: object
    t: object


def _np_tree(seed=0):
    """A tree of numpy leaves: dicts in unsorted insertion order, a list,
    a tuple and a NamedTuple; float32, float64, int32 and int64 leaves."""
    rng = np.random.default_rng(seed)
    return Carry(
        x={"w": rng.standard_normal((3, 4)).astype(np.float32),
           "b": [rng.standard_normal(4).astype(np.float64),
                 rng.integers(0, 9, (2,), dtype=np.int32)],
           "a": {"z": rng.integers(0, 9, (3,), dtype=np.int64),
                 "m": (rng.standard_normal(2).astype(np.float32),)}},
        y=rng.standard_normal((2, 2)).astype(np.float32),
        t=np.asarray(7, np.int64))


def _tree(seed=0):
    """``_np_tree`` with torch leaves (dicts in their insertion order),
    and ``t`` a Python int."""
    tree = torch.utils._pytree.tree_map(torch.from_numpy, _np_tree(seed))
    return tree._replace(t=7 + seed)


def _leaves(tree) -> list:
    """The leaves as numpy arrays, dict keys sorted."""
    return [leaf.numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in _flatten_with_paths(tree)[1]]


def _leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for p, q in zip(la, lb):
        assert p.dtype == q.dtype and p.shape == q.shape
        assert p.tobytes() == q.tobytes()


def _manifest(path) -> dict:
    with np.load(path) as data:
        return json.loads(bytes(data["__manifest__"]).decode())


def test_roundtrip_namedtuple_nested_bitwise(tmp_path):
    tree = _tree()
    p = tmp_path / "ck.npz"
    save_pytree(p, tree)
    got = restore_pytree(p, _tree(seed=1))   # template: structure only
    assert isinstance(got, Carry) and isinstance(got.t, int)
    assert got.t == 7
    assert list(got.x) == ["w", "b", "a"]    # the template's key order
    _leaves_equal(got, tree)
    assert all(isinstance(leaf, torch.Tensor)
               for leaf in jax.tree_util.tree_leaves(got.x))


def test_paths_sorted_as_jax_orders_them(tmp_path):
    """A dict's insertion order does not reach the file: the manifest's
    paths are JAX's, in its sorted-key order."""
    p = tmp_path / "ck.npz"
    save_pytree(p, _tree())
    want = ["/".join(str(k) for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(_np_tree())[0]]
    assert _manifest(p)["paths"] == want
    assert want[0] == ".x/['a']/['m']/[0]"


def test_int_leaf_and_device(tmp_path):
    p = tmp_path / "ck.npz"
    save_pytree(p, {"t": 3, "v": torch.arange(4, dtype=torch.int32)})
    assert _manifest(p)["dtypes"] == ["int64", "int32"]
    got = restore_pytree(p, {"t": 0, "v": torch.zeros(4, dtype=torch.int32)})
    assert got["t"] == 3 and type(got["t"]) is int
    assert got["v"].dtype == torch.int32 and got["v"].device.type == "cpu"


def test_bfloat16_refused_not_cast(tmp_path):
    p = tmp_path / "ck.npz"
    with pytest.raises(TypeError, match="bfloat16"):
        save_pytree(p, {"a": torch.zeros(3, dtype=torch.bfloat16)})
    assert not p.exists() and not list(tmp_path.iterdir())
    save_pytree(p, {"a": torch.zeros(3)})
    with pytest.raises(TypeError, match="bfloat16"):
        restore_pytree(p, {"a": torch.zeros(3, dtype=torch.bfloat16)})


def test_structure_mismatch_raises(tmp_path):
    p = tmp_path / "ck.npz"
    save_pytree(p, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_pytree(p, {"different": torch.zeros(3)})


def test_shape_and_dtype_mismatch_raise(tmp_path):
    p = tmp_path / "ck.npz"
    save_pytree(p, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(p, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore_pytree(p, {"a": torch.zeros(3, dtype=torch.float64)})


def test_crc_detects_bit_rot(tmp_path):
    """Flipped leaf bytes behind an intact manifest must be caught."""
    p = tmp_path / "ck.npz"
    save_pytree(p, {"a": torch.arange(8, dtype=torch.float32)})
    with np.load(p) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    arrays["leaf_0"] = arrays["leaf_0"] + 1.0   # stale CRC kept
    np.savez(p, **arrays)
    assert not verify_checkpoint(p)
    with pytest.raises(CorruptCheckpointError, match="CRC mismatch"):
        restore_pytree(p, {"a": torch.zeros(8)})


def test_truncated_archive_detected(tmp_path):
    p = tmp_path / "ck.npz"
    save_pytree(p, _tree())
    with open(p, "r+b") as fh:
        fh.truncate(os.path.getsize(p) // 3)
    assert not verify_checkpoint(p)
    with pytest.raises(CorruptCheckpointError):
        restore_pytree(p, _tree())


def test_manifest_dtype_record_detects_reinterpretation(tmp_path):
    p = tmp_path / "ck.npz"
    save_pytree(p, {"a": torch.arange(4, dtype=torch.float32)})
    with np.load(p) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    manifest = json.loads(bytes(arrays["__manifest__"]).decode())
    manifest["dtypes"] = ["int32"]
    manifest["crcs"] = [zlib.crc32(arrays["leaf_0"].tobytes())]
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(p, **arrays)
    assert not verify_checkpoint(p)
    with pytest.raises(CorruptCheckpointError, match="manifest records"):
        restore_pytree(p, {"a": torch.zeros(4)})


def test_save_is_atomic_no_temp_residue(tmp_path):
    save_pytree(tmp_path / "ck.npz", _tree())
    save_pytree(tmp_path / "ck.npz", _tree(seed=1))   # overwrite in place
    assert sorted(q.name for q in tmp_path.iterdir()) == ["ck.npz"]
    _leaves_equal(restore_pytree(tmp_path / "ck.npz", _tree()), _tree(seed=1))


def test_failed_save_leaves_previous_checkpoint_intact(tmp_path):
    class Unsaveable:
        def __array__(self, *a, **k):
            raise ValueError("not convertible")

    p = tmp_path / "ck.npz"
    save_pytree(p, _tree())
    with pytest.raises(ValueError, match="not convertible"):
        save_pytree(p, {"a": Unsaveable()})
    assert sorted(q.name for q in tmp_path.iterdir()) == ["ck.npz"]
    _leaves_equal(restore_pytree(p, _tree(seed=1)), _tree())


def test_latest_step_ordering_and_fallback(tmp_path):
    for s in (5, 10, 40):
        save_step(tmp_path, s, _tree(seed=s))
    assert latest_step(tmp_path) == 40
    with open(tmp_path / "step_00000040.npz", "r+b") as fh:
        fh.truncate(10)
    assert latest_step(tmp_path) == 10
    assert latest_step(tmp_path, validate=False) == 40
    assert valid_steps(tmp_path) == [5, 10]
    assert latest_step(tmp_path / "nope") is None


def test_stray_files_ignored(tmp_path):
    save_step(tmp_path, 3, _tree())
    (tmp_path / "step_final.npz").write_bytes(b"not a checkpoint")
    (tmp_path / "notes.txt").write_text("irrelevant")
    assert latest_step(tmp_path) == 3


def test_restore_step_fallback_warns_and_restores_older(tmp_path):
    save_step(tmp_path, 5, _tree(seed=5))
    save_step(tmp_path, 10, _tree(seed=10))
    with open(tmp_path / "step_00000010.npz", "r+b") as fh:
        fh.truncate(10)
    with pytest.raises(CorruptCheckpointError):
        restore_step(tmp_path, 10, _tree())
    with pytest.warns(UserWarning, match="fell back to step 5"):
        got = restore_step(tmp_path, 10, _tree(), fallback=True)
    _leaves_equal(got, _tree(seed=5))
    with pytest.raises(FileNotFoundError):
        restore_step(tmp_path, 4, _tree(), fallback=True)


def test_restore_latest_max_step_and_empty(tmp_path):
    assert restore_latest(tmp_path, _tree()) is None
    for s in (2, 4, 6):
        save_step(tmp_path, s, _tree(seed=s))
    tree, used = restore_latest(tmp_path, _tree())
    assert used == 6
    _leaves_equal(tree, _tree(seed=6))
    tree, used = restore_latest(tmp_path, _tree(), max_step=5)
    assert used == 4
    _leaves_equal(tree, _tree(seed=4))


def test_restore_latest_never_falls_back_past_wrong_template(tmp_path):
    save_step(tmp_path, 1, _tree())
    save_step(tmp_path, 2, {"other": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_latest(tmp_path, _tree())


# -- across the two packages ------------------------------------------------

def _write(side: str, path):
    if side == "port":
        save_pytree(path, _tree())
    else:
        jckpt.save_pytree(path, _np_tree())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_packages(tmp_path, writer):
    """A file either package writes verifies and restores in the other,
    leaves equal; a file of the same tree from each has the same
    manifest: paths, dtypes and CRCs."""
    p = tmp_path / "ck.npz"
    _write(writer, p)
    assert verify_checkpoint(p) and jckpt.verify_checkpoint(p)
    got_port = restore_pytree(p, _tree(seed=1))
    got_jax = jckpt.restore_pytree(p, _np_tree(seed=1))
    _leaves_equal(got_port, _tree())
    want = jax.tree_util.tree_leaves(_np_tree())
    for a, b in zip(jax.tree_util.tree_leaves(got_jax), want, strict=True):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    other = tmp_path / "other.npz"
    _write("jax" if writer == "port" else "port", other)
    assert _manifest(p) == _manifest(other)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_both_reject_damaged_file(tmp_path, writer, damage):
    p = tmp_path / "ck.npz"
    _write(writer, p)
    if damage == "flip":
        with open(p, "r+b") as fh:                # one byte, mid-file
            fh.seek(os.path.getsize(p) // 2)
            byte = fh.read(1)[0]
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([byte ^ 0x01]))
    else:
        with open(p, "r+b") as fh:
            fh.truncate(os.path.getsize(p) // 2)
    assert not verify_checkpoint(p) and not jckpt.verify_checkpoint(p)
    with pytest.raises(CorruptCheckpointError):
        restore_pytree(p, _tree())
    with pytest.raises(jckpt.CorruptCheckpointError):
        jckpt.restore_pytree(p, _np_tree())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_version1_manifest_still_restores(tmp_path, writer):
    """A pre-CRC file (a bare path-list manifest) restores in both."""
    p = tmp_path / "ck.npz"
    _write(writer, p)
    with np.load(p) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    manifest = json.loads(bytes(arrays["__manifest__"]).decode())
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest["paths"]).encode(), dtype=np.uint8)
    np.savez(p, **arrays)
    _leaves_equal(restore_pytree(p, _tree(seed=1)), _tree())
    got = jckpt.restore_pytree(p, _np_tree(seed=1))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(_np_tree()), strict=True):
        assert np.asarray(a).tobytes() == b.tobytes()

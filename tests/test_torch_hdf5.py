"""dmnerf_torch/utils/hdf5.py against h5py: read_dataset returns what h5py
returns (dtype, shape and values, exactly) on files h5py wrote with libver
"earliest" (superblock 0, a symbol-table group) and "latest" (superblock 3,
version-2 object headers, link messages), in contiguous and compact
layouts; h5py reads back what write_dataset wrote, equal; structures the
reader does not decode raise a ValueError that names them."""

import h5py
import numpy as np
import pytest

from dmnerf_torch.utils.hdf5 import read_dataset, write_dataset

DTYPES = ["uint8", "int16", "int32", "float32", "float64"]
SHAPES = [(17, 3), (65, 3), (0, 3)]


def _array(dtype, shape, seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * 100).astype(dtype)


def _h5py_read(path, name="datasets"):
    with h5py.File(path, "r") as f:
        return f[name][()]


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_read_dataset_equals_h5py(tmp_path, libver, dtype, shape):
    path = str(tmp_path / "p.hdf5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("datasets", data=_array(dtype, shape))
    _equal(read_dataset(path, "datasets"), _h5py_read(path))


@pytest.mark.parametrize("shape", SHAPES + [(5,), ()])
@pytest.mark.parametrize("dtype", DTYPES + ["int8", "uint16", "uint64", ">i4", ">f8"])
def test_h5py_reads_back_what_write_dataset_wrote(tmp_path, dtype, shape):
    path = str(tmp_path / "w.hdf5")
    arr = _array(dtype, shape, seed=1)
    write_dataset(path, "datasets", arr)
    _equal(_h5py_read(path), arr)
    _equal(read_dataset(path, "datasets"), arr)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_read_dataset_compact_layout_and_other_names(tmp_path, libver):
    path = str(tmp_path / "c.hdf5")
    arr = np.arange(12, dtype=np.int16).reshape(4, 3)
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("first", data=np.arange(3.0))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"datasets", h5py.h5t.NATIVE_INT16,
                             h5py.h5s.create_simple(arr.shape), dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)
        f.create_dataset("last", data=np.arange(5, dtype=np.uint8))
    _equal(read_dataset(path, "datasets"), arr)
    _equal(read_dataset(path, "first"), _h5py_read(path, "first"))
    _equal(read_dataset(path, "last"), _h5py_read(path, "last"))


def test_read_dataset_walks_a_b_tree_of_many_symbol_nodes(tmp_path):
    """Forty datasets spread over several SNOD nodes of the root B-tree."""
    path = str(tmp_path / "m.hdf5")
    with h5py.File(path, "w") as f:
        for i in range(40):
            f.create_dataset(f"d{i}", data=np.arange(i + 1, dtype=np.int32))
    for i in (0, 17, 39):
        _equal(read_dataset(path, f"d{i}"), np.arange(i + 1, dtype=np.int32))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_read_dataset_follows_continuation_blocks(tmp_path, libver):
    """Attributes added after the dataset overflow its first object header
    chunk into continuation blocks (OCHK blocks in version-2 headers)."""
    path = str(tmp_path / "a.hdf5")
    arr = np.arange(51, dtype=np.uint8).reshape(17, 3)
    with h5py.File(path, "w", libver=libver) as f:
        ds = f.create_dataset("datasets", data=arr)
        for i in range(6):
            ds.attrs[f"a{i}"] = np.arange(40.0)
    _equal(read_dataset(path, "datasets"), arr)


@pytest.mark.parametrize("what", ["chunked", "filtered", "dense_links", "missing",
                                  "string", "not_hdf5"])
def test_read_dataset_raises_on_what_it_does_not_decode(tmp_path, what):
    path = str(tmp_path / "x.hdf5")
    field = {"chunked": "chunked", "filtered": "filter pipeline", "dense_links": "dense",
             "missing": "no object", "string": "datatype class", "not_hdf5": "signature"}
    libver = "latest" if what == "dense_links" else "earliest"
    if what == "not_hdf5":
        open(path, "wb").write(b"not an hdf5 file" * 64)
    else:
        with h5py.File(path, "w", libver=libver) as f:
            if what == "chunked":
                f.create_dataset("datasets", data=np.zeros((17, 3)), chunks=(4, 3))
            elif what == "filtered":
                f.create_dataset("datasets", data=np.zeros((17, 3)), compression="gzip")
            elif what == "dense_links":
                for i in range(40):
                    f.create_dataset(f"d{i}", data=np.zeros(2))
                f.create_dataset("datasets", data=np.zeros(2))
            elif what == "missing":
                f.create_dataset("other", data=np.zeros(2))
            else:
                f.create_dataset("datasets", data=np.array([b"ab", b"cd"]))
    with pytest.raises(ValueError, match=field[what]) as err:
        read_dataset(path, "datasets")
    assert path in str(err.value)

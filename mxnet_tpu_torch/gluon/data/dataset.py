"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``,
reference python/mxnet/gluon/data/dataset.py): Dataset, SimpleDataset
and ArrayDataset with the same transform semantics.
``RecordFileDataset`` needs RecordIO, which stays with the long tail
(ROADMAP A.10)."""
from __future__ import annotations

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset"]


class Dataset:
    """Random-access collection of samples: ``__getitem__`` + ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """Map ``fn`` over samples.  Lazy by default (applied per access);
        ``lazy=False`` materialises the whole mapped dataset now."""
        mapped = _MappedDataset(self, fn)
        if lazy:
            return mapped
        return SimpleDataset([mapped[i] for i in range(len(mapped))])

    def transform_first(self, fn, lazy=True):
        """Map ``fn`` over only the first field of each sample (the usual
        image-not-label case)."""
        return self.transform(_FirstFieldTransform(fn), lazy)


class SimpleDataset(Dataset):
    """View any indexable sequence as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _MappedDataset(Dataset):
    """Lazy element-wise transform; tuple samples are splatted into ``fn``."""

    def __init__(self, source, fn):
        self._source = source
        self._fn = fn

    def __len__(self):
        return len(self._source)

    def __getitem__(self, idx):
        sample = self._source[idx]
        return self._fn(*sample) if isinstance(sample, tuple) \
            else self._fn(sample)


class _FirstFieldTransform:
    """Picklable closure: apply ``fn`` to field 0, pass the rest through."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, first, *rest):
        return (self._fn(first), *rest) if rest else self._fn(first)


class ArrayDataset(Dataset):
    """Zip one or more equal-length array-likes; single-array datasets yield
    bare elements, multi-array datasets yield tuples."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("Needs at least 1 arrays")
        from ...ndarray import NDArray
        self._length = len(arrays[0])
        self._fields = []
        for i, arr in enumerate(arrays):
            if len(arr) != self._length:
                raise ValueError(
                    f"All arrays must have the same length; array[0] has "
                    f"length {self._length} while array[{i}] has {len(arr)}.")
            if isinstance(arr, NDArray) and arr.ndim == 1:
                arr = arr.asnumpy()
            self._fields.append(arr)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        row = tuple(field[idx] for field in self._fields)
        return row[0] if len(row) == 1 else row

"""``encode_sentences`` and ``BucketSentenceIter``: bucketed
language-model batches.

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference
python/mxnet/rnn/io.py): each sentence goes to the smallest bucket that
holds it, padded there with ``invalid_label``; batches come bucket by
bucket with their ``bucket_key`` and ``provide_data``/``provide_label``,
so ``BucketingModule`` binds the bucket's module; the labels are the
inputs shifted left by one.  The order of the batches and of the
sentences inside each bucket is shuffled at every ``reset`` from
Python's global ``random`` stream and numpy's global stream, the two the
JAX package's iterator draws from, so one seed of both gives the two
packages the same batches (the port's other iterators draw from
``random.host_rng``).
"""
from __future__ import annotations

import random as _pyrandom

import numpy as _np

from ..base import MXNetError
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sequences to int ids, building the vocab on the fly
    (reference rnn/io.py encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    raise ValueError("unknown token %s" % word)
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator over encoded sentences (see module docstring)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = _np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(counts)
                       if n >= batch_size]
        buckets = sorted(buckets)
        if not buckets:
            raise MXNetError("no usable buckets for this corpus")

        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = _np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = _np.full((buckets[buck],), invalid_label,
                            _np.dtype(dtype))
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [_np.asarray(x, _np.dtype(dtype)).reshape(-1, b)
                     for x, b in zip(self.data, buckets)]
        if ndiscard:
            import logging
            logging.warning("discarded %d sentences longer than the "
                            "largest bucket", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.default_bucket_key = max(buckets)

        self.provide_data = [DataDesc(data_name,
                                      (batch_size, self.default_bucket_key),
                                      dtype, layout=layout)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, self.default_bucket_key),
                                       dtype, layout=layout)]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend((i, j) for j in
                            range(0, len(buck) - batch_size + 1, batch_size))
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)
        # label = input shifted left by one (next-token prediction)
        self.ndlabel = []
        self.nddata = []
        for buck in self.data:
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next(self):
        from ..context import cpu
        from ..ndarray.ndarray import array
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        key = self.buckets[i]
        return DataBatch(data=[array(data, ctx=cpu())],
                         label=[array(label, ctx=cpu())],
                         bucket_key=key, pad=0,
                         provide_data=[DataDesc(self.data_name,
                                                (self.batch_size, key),
                                                self.dtype,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name,
                                                 (self.batch_size, key),
                                                 self.dtype,
                                                 layout=self.layout)])

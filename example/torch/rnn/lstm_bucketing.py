#!/usr/bin/env python
"""LSTM language model through ``BucketingModule`` on the PyTorch port
(the port's copy of MXNet's example/rnn/bucketing/lstm_bucketing.py).

The defaults are the reference example's: 2 LSTM layers of 200 units,
200-wide embeddings, batch 32, buckets 10-60, SGD at 0.01 with weight
decay 1e-5, perplexity ignoring the pad label 0, ``kvstore='device'``.
``--gc-type 2bit`` compresses the gradients (threshold
``--gc-threshold``), ``--fused`` replaces the stack of step cells by
one ``FusedRNNCell`` (the fused ``RNN`` op).  Without ``--train-data``
(a tokenized text file, one sentence a line) it trains on a corpus drawn
from ``--seed``: ``--num-sentences`` sentences over PTB's 10000-word
vocabulary (output layer 10001 wide, pad included), lengths and word
frequencies shaped like PTB's (about 21 words a sentence, Zipf
frequencies, each word followed mostly by a few successors).  On the
card by default; ``--ctx cpu`` trains on the CPU::

  python3 example/torch/rnn/lstm_bucketing.py --num-epochs 1 \\
      --num-sentences 2000 [--gc-type 2bit] [--fused] [--ctx cpu]

Ends with ``final train metrics [...], finite True`` and the tokens a
second (pads left out).
"""
import argparse
import logging
import math
import os
import random
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx


def synthetic_corpus(n_sentences, vocab_size, seed):
    """``n_sentences`` token lists: lengths from a gamma of mean ~21,
    the first word Zipf, every later word one of its predecessor's 8
    successors (Zipf over them) or, one time in five, any Zipf word."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    zipf = 1.0 / ranks
    zipf /= zipf.sum()
    succ = rng.choice(vocab_size, size=(vocab_size, 8), p=zipf)
    succ_p = 1.0 / np.arange(1, 9)
    succ_p /= succ_p.sum()
    lengths = np.clip(rng.gamma(3.0, 7.0, n_sentences).astype(int), 2, 80)
    longest = int(lengths.max())
    words = np.empty((n_sentences, longest), dtype=np.int64)
    words[:, 0] = rng.choice(vocab_size, n_sentences, p=zipf)
    for t in range(1, longest):
        follow = succ[words[:, t - 1], rng.choice(8, n_sentences, p=succ_p)]
        jump = rng.choice(vocab_size, n_sentences, p=zipf)
        words[:, t] = np.where(rng.rand(n_sentences) < 0.2, jump, follow)
    return [["w%d" % w for w in row[:n]] for row, n in zip(words, lengths)]


def tokenize_file(fname):
    with open(fname) as f:
        return [line.split() for line in f if line.strip()]


def main():
    parser = argparse.ArgumentParser(
        description="Train an LSTM LM with bucketing",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--train-data", type=str, default=None)
    parser.add_argument("--num-sentences", type=int, default=42068,
                        help="sentences of the drawn corpus (PTB's train "
                             "split has 42068)")
    parser.add_argument("--vocab-size", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--num-layers", type=int, default=2)
    parser.add_argument("--num-hidden", type=int, default=200)
    parser.add_argument("--num-embed", type=int, default=200)
    parser.add_argument("--buckets", type=str, default="10,20,30,40,50,60")
    parser.add_argument("--ctx", type=str, default="gpu",
                        choices=("gpu", "cpu"))
    parser.add_argument("--kv-store", type=str, default="device")
    parser.add_argument("--gc-type", type=str, default="none",
                        choices=("none", "2bit"))
    parser.add_argument("--gc-threshold", type=float, default=0.5)
    parser.add_argument("--fused", action="store_true",
                        help="one FusedRNNCell (the fused RNN op) in place "
                             "of the stack of LSTMCells")
    parser.add_argument("--num-epochs", type=int, default=25)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--optimizer", type=str, default="sgd")
    parser.add_argument("--mom", type=float, default=0.0)
    parser.add_argument("--wd", type=float, default=0.00001)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--disp-batches", type=int, default=50)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    random.seed(args.seed)
    np.random.seed(args.seed)
    mx.random.seed(args.seed)

    if args.train_data:
        sents = tokenize_file(args.train_data)
    else:
        sents = synthetic_corpus(args.num_sentences, args.vocab_size,
                                 args.seed)
    encoded, vocab = mx.rnn.encode_sentences(sents, invalid_label=0,
                                             invalid_key="\n",
                                             start_label=1)
    # the drawn corpus keeps the whole vocabulary's width (pad included),
    # whichever words a short corpus happens to hold
    vocab_size = len(vocab) if args.train_data else args.vocab_size + 1
    buckets = [int(b) for b in args.buckets.split(",")]
    train = mx.rnn.BucketSentenceIter(encoded, args.batch_size,
                                      buckets=buckets, invalid_label=0)
    print("corpus: %d sentences, %d batches an epoch, vocab %d, buckets %s"
          % (len(sents), len(train.idx), vocab_size, buckets), flush=True)

    H, L = args.num_hidden, args.num_layers
    if args.fused:
        cell = mx.rnn.FusedRNNCell(H, num_layers=L, mode="lstm",
                                   prefix="lstm_")
    else:
        cell = mx.rnn.SequentialRNNCell()
        for i in range(L):
            cell.add(mx.rnn.LSTMCell(num_hidden=H, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size,
                                 output_dim=args.num_embed, name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                                 merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, H))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab_size,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, use_ignore=True,
                                    ignore_label=0, name="softmax")
        return pred, ("data",), ("softmax_label",)

    ctx = mx.cpu() if args.ctx == "cpu" else mx.gpu(0)
    compression = {"type": "2bit", "threshold": args.gc_threshold} \
        if args.gc_type == "2bit" else None
    model = mx.mod.BucketingModule(
        sym_gen, default_bucket_key=train.default_bucket_key, context=ctx,
        compression_params=compression)
    # an instance: with one device the string gives no store, and no
    # compression (the JAX package's rule)
    kv = mx.kv.create(args.kv_store) if args.kv_store != "none" else None
    metric = mx.metric.Perplexity(ignore_label=0)
    shown = {}
    speedometer = mx.callback.Speedometer(args.batch_size,
                                          args.disp_batches)
    tokens = [0]

    def on_batch(param):
        # the values the Speedometer is about to show (and reset)
        shown["last"] = param.eval_metric.get_name_value()
        speedometer(param)

    class _Counting:
        """The iterator, counting the tokens that are not pads."""

        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def __iter__(self):
            for batch in self.inner:
                tokens[0] += int((batch.label[0].asnumpy() != 0).sum())
                yield batch

        def reset(self):
            self.inner.reset()

    t0 = time.perf_counter()
    model.fit(_Counting(train), eval_metric=metric, kvstore=kv,
              optimizer=args.optimizer,
              optimizer_params={"learning_rate": args.lr,
                                "momentum": args.mom, "wd": args.wd},
              initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
              num_epoch=args.num_epochs, batch_end_callback=on_batch)
    seconds = time.perf_counter() - t0
    final = metric.get_name_value() or shown.get("last", [])
    if not final or any(math.isnan(v) for _, v in final):
        final = shown.get("last", final)
    arg_params, _ = model.get_params()
    finite = all(math.isfinite(v) for _, v in final) and all(
        np.isfinite(v.asnumpy()).all() for v in arg_params.values())
    print("tokens/s %.1f (%d tokens, pads left out, %.1f s)"
          % (tokens[0] / seconds, tokens[0], seconds), flush=True)
    logging.info("final train metrics %s, finite %s", final, finite)
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())

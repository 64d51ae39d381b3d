#!/usr/bin/env python
"""Character-level LSTM language model on committed text
(tests/fixtures/public_domain_text.txt, public-domain English prose and
verse) through ``BucketingModule`` on the PyTorch port (the port's copy
of example/rnn/char_lm.py): lines become character sequences, bucketed
by length, one captured fit graph a bucket over one set of weights.

Prints the train perplexity curve and exits 0 only when the final
perplexity clears ``--target-ppl`` (4.5 by default, against a vocabulary
of ~45 characters whose uniform perplexity is ~45 and unigram
perplexity ~17).  On the card by default; ``--ctx cpu`` trains on the
CPU::

  python3 example/torch/rnn/char_lm.py [--ctx cpu]
"""
import argparse
import logging
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

import numpy as np

import mxnet_tpu_torch as mx

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "..", "..", "tests",
                       "fixtures", "public_domain_text.txt")


def char_sentences(path, max_len=96):
    """Lines as lists of characters (lowercased, blank lines dropped),
    cut to at most ``max_len`` characters so buckets stay compact."""
    sents = []
    with open(path) as f:
        for line in f:
            line = line.strip().lower()
            if not line:
                continue
            chars = list(line)
            for i in range(0, len(chars), max_len):
                piece = chars[i:i + max_len]
                if len(piece) >= 4:
                    sents.append(piece)
    return sents


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-hidden", type=int, default=192)
    ap.add_argument("--num-embed", type=int, default=32)
    ap.add_argument("--num-layers", type=int, default=1)
    ap.add_argument("--num-epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--buckets", type=str, default="16,32,48,64,96")
    ap.add_argument("--target-ppl", type=float, default=4.5)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--ctx", type=str, default="gpu", choices=("gpu", "cpu"))
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    random.seed(args.seed)
    np.random.seed(args.seed)
    mx.random.seed(args.seed)

    sents = char_sentences(FIXTURE)
    encoded, vocab = mx.rnn.encode_sentences(sents, invalid_label=0,
                                             invalid_key="<pad>",
                                             start_label=1)
    vocab_size = len(vocab) + 1
    print("fixture: %d char sequences, vocab %d" % (len(sents), vocab_size))
    buckets = [int(b) for b in args.buckets.split(",")]
    train = mx.rnn.BucketSentenceIter(encoded, args.batch_size,
                                      buckets=buckets, invalid_label=0)

    stack = mx.rnn.SequentialRNNCell()
    for i in range(args.num_layers):
        stack.add(mx.rnn.LSTMCell(num_hidden=args.num_hidden,
                                  prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size,
                                 output_dim=args.num_embed, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, layout="NTC",
                                  merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, args.num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab_size,
                                     name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                    ignore_label=0, name="softmax")
        return pred, ("data",), ("softmax_label",)

    ctx = mx.cpu() if args.ctx == "cpu" else mx.gpu(0)
    model = mx.mod.BucketingModule(
        sym_gen, default_bucket_key=train.default_bucket_key, context=ctx)
    metric = mx.metric.Perplexity(ignore_label=0)
    per_epoch = {}

    def tap(param):
        # fit resets the metric at each epoch's start, so the last
        # batch-end value of an epoch is that epoch's train perplexity
        per_epoch[param.epoch] = param.eval_metric.get_name_value()[0][1]

    model.fit(train, num_epoch=args.num_epochs, eval_metric=metric,
              optimizer="adam", optimizer_params={"learning_rate": args.lr},
              initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
              batch_end_callback=tap)
    curve = [per_epoch[e] for e in sorted(per_epoch)]
    for epoch in range(0, len(curve), 5):
        print("epoch %2d: train perplexity %.3f" % (epoch, curve[epoch]))
    print("perplexity curve:",
          " ".join("%.2f" % p for p in curve[::max(1, len(curve) // 10)]))
    final = curve[-1]
    print("final train perplexity: %.3f (vocab %d)" % (final, vocab_size),
          flush=True)
    if not final < args.target_ppl:
        print("char LM did not reach %.2f (got %.3f)"
              % (args.target_ppl, final))
        return 1
    print("char_lm OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

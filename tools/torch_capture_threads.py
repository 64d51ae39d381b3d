#!/usr/bin/env python3
"""Which CUDA calls a second thread may make while the first captures a
CUDA graph in ``"thread_local"`` mode (the mode of
``mxnet_tpu_torch/cuda_graph.py``).

    python3 tools/torch_capture_threads.py

For each call (a kernel launch on the default stream and on a side
stream, a readback, a pinned copy with a stream sync, a 1 GB
allocation, an event sync, another graph's replay, ``empty_cache``, a
device-wide ``torch.cuda.synchronize``), a thread opens a capture of 100
matrix products, the main thread makes the call mid-capture, and one
line says whether the call, the capture and a synchronize after both
succeeded.  Needs one CUDA device.
"""
import threading
import time

import torch


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev) * 0.01
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x @ x
    torch.cuda.synchronize()
    other = torch.cuda.CUDAGraph()
    with torch.cuda.graph(other):
        x @ x

    def body():
        y = x
        for _ in range(50):
            y = y @ x
        return y

    def capture(started, res):
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body()
        stream.synchronize()
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            started.set()
            try:
                body()
                time.sleep(0.3)
                body()
            except RuntimeError as exc:
                res["body"] = repr(exc)[:160]
            try:
                graph.capture_end()
                res["capture"] = "ok"
            except RuntimeError as exc:
                res["capture"] = repr(exc)[:160]
        if res.get("capture") == "ok":
            graph.replay()
            torch.cuda.current_stream().synchronize()

    def side_launch():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            x.mul(2)
        s.synchronize()

    def pinned_copy():
        h = torch.empty(1 << 20, pin_memory=True)
        d = torch.empty(1 << 20, device=dev)
        d.copy_(h, non_blocking=True)
        torch.cuda.current_stream().synchronize()

    def event_sync():
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()

    calls = {
        "launch_default_stream": lambda: torch.ones(10, device=dev) * 2,
        "launch_side_stream_and_sync": side_launch,
        "readback_default_stream":
            lambda: (torch.ones(10, device=dev) * 3).cpu(),
        "pinned_h2d_and_stream_sync": pinned_copy,
        "malloc_1gb":
            lambda: torch.empty(1 << 30, dtype=torch.uint8, device=dev),
        "event_record_sync": event_sync,
        "graph_replay": other.replay,
        "empty_cache": torch.cuda.empty_cache,
        "device_synchronize": torch.cuda.synchronize,
    }
    for name, fn in calls.items():
        started, res = threading.Event(), {}
        t = threading.Thread(target=capture, args=(started, res))
        t.start()
        started.wait()
        time.sleep(0.05)
        try:
            fn()
            res["call"] = "ok"
        except RuntimeError as exc:
            res["call"] = repr(exc)[:160]
        t.join()
        try:
            torch.cuda.synchronize()
            res["after"] = "ok"
        except RuntimeError as exc:
            res["after"] = repr(exc)[:160]
        print(name, res, flush=True)


if __name__ == "__main__":
    main()

"""The memory of one sequential SSD scan on the plain route, traced alone.

    PYTHONPATH=src python scripts/ssd_scan_trace.py [--batch 16] [--heads 5]
        [--head-dim 64] [--state 128] [--steps 4096]

runs ``kernels.ref.ssd_scan_ref`` (the training scan; the recurrence a
step per token) on ``meta`` tensors of one device's shard, bfloat16
inputs as the models give it, under ``launch.trace``'s counting mode
(the closed form past ``trace.STEPWISE_MAX`` steps), and prints one JSON
line: without autograd, the peak of the scan's own storages and the
bytes of its output rows; with autograd, the bytes the forward leaves
alive for the backward, per step, beside one float32 state ``[b, H, P,
N]``; and the peak over forward and backward.  The defaults are
mamba2-2.7b's train_4k shard on the ``(16, 16)`` mesh (16 rows, 80 / 16
heads).
"""
import argparse
import json

import torch

from repro_torch.kernels import ref
from repro_torch.launch import trace


def scan_bytes(b: int, H: int, P: int, N: int, L: int, grad: bool) -> dict:
    def leaf(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, device="meta", dtype=dtype,
                           requires_grad=grad)

    x, dt, A = leaf(b, L, H, P), leaf(b, L, H, dtype=torch.float32), \
        leaf(H, dtype=torch.float32)
    B, C = leaf(b, L, N), leaf(b, L, N)
    counter = trace.Counter([x, dt, A, B, C])
    with trace.counting(counter):
        y = ref.ssd_scan_ref(x, dt, A, B, C)
        out = {"forward_peak_bytes": counter.peak,
               "left_alive_bytes": counter.live}
        if grad:
            torch.autograd.grad(y, [x, dt, A, B, C], torch.empty_like(y))
            out["forward_backward_peak_bytes"] = counter.peak
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--heads", type=int, default=5)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--state", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4096)
    a = ap.parse_args(argv)
    b, H, P, N, L = a.batch, a.heads, a.head_dim, a.state, a.steps
    plain = scan_bytes(b, H, P, N, L, grad=False)
    grad = scan_bytes(b, H, P, N, L, grad=True)
    print(json.dumps({
        "shape": {"batch": b, "heads": H, "head_dim": P, "state": N,
                  "steps": L},
        "state_bytes": b * H * P * N * 4, "output_row_bytes": b * H * P * 4,
        "no_grad": plain,
        "autograd": {**grad, "left_alive_per_step_bytes":
                     grad["left_alive_bytes"] / L}}))


if __name__ == "__main__":
    main()

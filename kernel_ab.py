"""Time the strip-gather and CTC kernels of several source trees on one card,
in turns.

    python3 kernel_ab.py TREE [TREE ...] [--rounds 2] [--twin]

Each TREE is a directory holding a copy of the repository: this checkout
(`.`), the parent commit unpacked with `git archive` into a git-ignored
directory, or a copy with a kernel variant. Every tree runs in a process of
its own, from its own root, with its own `chip_smoke.py` and package: the
launch floor and the kernel phase's gather and CTC checks (each kernel
against its plain version, then timed behind a spin), and the CTC forward
with alpha at B = 1536. The trees run in turns, `--rounds` times (A, B, A,
B), so that versions are compared on one card within one call. Prints one
JSON line per tree and round. Needs a CUDA device.

`--twin` times the channel-major UNet twin instead: its eval forward at
full width (D=8, 400x512, f=32, seeded weights), by CUDA events around one
call (chip_smoke's `median_ms`) and by the host clock with a synchronise,
and one padded-flat conv call at a small shape (D=1, 16 -> 16 channels,
8x64), the host's time a call over 200 calls: the Python cost of reaching
the kernel, the part the dispatch route changes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# run from the tree's root, so that its chip_smoke and package are imported
_CHILD = """
import json, torch
import chip_smoke as smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
card = smoke.gpu_line()
floor = smoke.device_ms(torch, lambda: torch.cuda._sleep(0))
gather_fwd, gather_bwd = smoke.check_gather(torch, dev, card)
ctc_fwd, ctc_bwd = smoke.check_ctc(torch, dev, card)
# the forward with alpha at B = 1536, on check_ctc's inputs there, in every
# tree (a tree's check_ctc may time it without alpha only)
from qea_ocr_tpu_torch.ops.cuda import ctc_cuda
lp, labels, lengths, g, V = smoke._ctc_inputs(torch, dev, 1536, 21)
ctc_fwd["with_alpha_ms_b1536"] = smoke.device_ms(
    torch, lambda: ctc_cuda.ctc_nll_cuda(lp, labels, lengths, V,
                                         want_alpha=True))
print("RESULT " + json.dumps(dict(
    card=card, floor_ms=floor, gather_fwd=gather_fwd, gather_bwd=gather_bwd,
    ctc_fwd=ctc_fwd, ctc_bwd=ctc_bwd)), flush=True)
"""

_TWIN_CHILD = """
import json, time
import numpy as np
import torch
import chip_smoke as smoke
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.ops import conv_cmajor
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
card = smoke.gpu_line()
vanilla = UNet(init_features=smoke.UNET_FEATURES,
               generator=torch.Generator().manual_seed(0)).to(dev).eval()
twin = vanilla.twin("cmajor").eval()
x = torch.rand((smoke.D, 1, *smoke.DOC_SIZE),
               generator=torch.Generator().manual_seed(1)).to(dev)
xf = conv_cmajor.pad_flat(torch.rand((1, 16, 8, 64), device=dev))
w = torch.rand((3, 3, 16, 16), device=dev).to(torch.bfloat16)


def host_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


with torch.no_grad():
    events = smoke.median_ms(torch, lambda: twin(x), iters=20)
    host = float(np.median([host_ms(lambda: twin(x), 1) for _ in range(20)]))
    call = host_ms(lambda: conv_cmajor._conv_flat(xf, w, None, 8, 64), 200)
print("RESULT " + json.dumps(dict(
    card=card, twin_events_ms=events, twin_host_ms=host,
    conv_call_us=1e3 * call)), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--twin", action="store_true",
                    help="time the channel-major UNet twin instead")
    args = ap.parse_args(argv)
    child = _TWIN_CHILD if args.twin else _CHILD
    for _ in range(args.rounds):
        for tree in args.trees:
            proc = subprocess.run([sys.executable, "-c", child],
                                  cwd=os.path.abspath(tree),
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                return proc.returncode
            result = json.loads(next(
                line[7:] for line in proc.stdout.splitlines()
                if line.startswith("RESULT ")))
            print(json.dumps(dict(tree=tree, **result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

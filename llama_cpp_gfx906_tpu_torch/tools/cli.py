"""Greedy text generation from a llama GGUF.

Usage:
    python -m llama_cpp_gfx906_tpu_torch.tools.cli -m model.gguf -p "prompt" -n 32 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..runtime.engine import Engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="greedy generation (PyTorch/CUDA port)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-n", "--n-predict", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    eng = Engine.from_gguf(args.model, device=args.device, dtype=torch.bfloat16)
    text, _ = eng.generate(args.prompt, n_predict=args.n_predict)
    sys.stdout.write(args.prompt + text + "\n")
    print(json.dumps(eng.perf.summary()), file=sys.stderr)


if __name__ == "__main__":
    main()

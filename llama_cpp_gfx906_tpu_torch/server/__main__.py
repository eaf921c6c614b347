"""``python -m llama_cpp_gfx906_tpu_torch.server``: the OpenAI-compatible
server on the PyTorch/CUDA port."""

from .app import main

if __name__ == "__main__":
    raise SystemExit(main())

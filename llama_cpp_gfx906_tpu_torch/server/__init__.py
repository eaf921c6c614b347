"""OpenAI-compatible continuous-batching HTTP server (port of
``llama_cpp_gfx906_tpu/server``)."""

from .app import InferenceServer, main, make_server  # noqa: F401

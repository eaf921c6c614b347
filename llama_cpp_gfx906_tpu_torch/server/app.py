"""OpenAI-compatible HTTP server with continuous batching (port of
``llama_cpp_gfx906_tpu/server/app.py``).

Architecture: the standard library's ``ThreadingHTTPServer`` runs one
thread per connection; handlers push requests onto a queue; one engine
thread runs the ``BatchedEngine`` loop (admit -> step -> emit) and hands
tokens back through a queue per request.  Streams are server-sent events
written by hand, ending in ``data: [DONE]``.

Endpoints: GET /health, /props, /metrics (Prometheus text), /slots,
/models, /v1/models; POST /tokenize, /detokenize, /completion,
/completions, /v1/completions (text or token-id prompts, ``n`` >= 1,
stream or not, stop strings), /chat/completions, /v1/chat/completions
(stream or not).  A request for a feature the port lacks (grammar, JSON
schema, logprobs, LoRA, images, tools, embeddings, rerank, infill, slot
files, POST /props) gets HTTP 400 naming it.

Run: ``python -m llama_cpp_gfx906_tpu_torch.server -m model.gguf
[-np 4] [-c 2048] [-ctk q8] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import kernels
from ..runtime.batch_engine import BatchedEngine, SamplerConfig, Slot

log = logging.getLogger("lcg.server")


class PendingRequest:
    def __init__(self, prompt_ids, n_predict, sampler, stop_strings,
                 n_keep=0, truncate=True):
        self.id = f"req-{uuid.uuid4().hex[:12]}"
        self.prompt_ids = prompt_ids
        self.n_predict = n_predict
        self.sampler = sampler
        self.stop_strings = stop_strings or []
        self.n_keep = n_keep
        self.truncate = truncate
        self.token_queue: queue.Queue = queue.Queue()
        self.cancelled = False
        self.t_arrival = time.perf_counter()

    def emit(self, item):
        self.token_queue.put(item)


class InferenceServer:
    """Owns the engine thread and the task queue."""

    def __init__(self, engine: BatchedEngine, model_name: str = "model"):
        self.engine = engine
        self.model_name = model_name
        self.timeout = 600  # per-token wait budget (--timeout)
        self.default_n_keep = 0  # context-shift anchor default (--keep)
        self.tasks: queue.Queue[PendingRequest] = queue.Queue()
        self.by_slot: dict[int, PendingRequest] = {}
        self.running = False
        self.thread: threading.Thread | None = None
        self.t_start = time.time()
        self.deferred: list[PendingRequest] = []
        # held by the engine thread for each step: /metrics reads the device
        # launch counts between steps, never inside a graph capture
        self.step_lock = threading.Lock()

    def start(self):
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def stop(self):
        self.running = False
        if self.thread:
            self.thread.join(timeout=10)

    def submit(self, req: PendingRequest):
        self.tasks.put(req)

    # -- engine thread --------------------------------------------------------

    def _admit(self):
        """Move queued requests into free slots; the prompt prefills in
        chunks inside ``engine.step()``."""
        pending = self.deferred
        self.deferred = []
        while True:
            if not pending:
                try:
                    pending.append(self.tasks.get_nowait())
                except queue.Empty:
                    break
            req = pending.pop(0)
            if req.cancelled:
                continue
            try:
                slot = self.engine.add_request(
                    req.prompt_ids, req.n_predict, req.sampler, req.id,
                    n_keep=req.n_keep, truncate=req.truncate)
            except Exception as e:  # noqa: BLE001 (fail this request; the loop lives on)
                req.emit(("error", f"{type(e).__name__}: {e}"))
                continue
            if slot is None:
                self.deferred.append(req)
                self.deferred.extend(pending)
                break
            self.by_slot[slot.id] = req

    def _finish(self, slot: Slot):
        req = self.by_slot.pop(slot.id, None)
        if req is not None:
            req.emit(("done", {"reason": slot.stop_reason or "stop",
                               "n_truncated": slot.n_truncated}))
        self.engine.release(slot)

    def _loop(self):
        while self.running:
            try:
                self._admit()
                for slot_id, req in list(self.by_slot.items()):
                    if req.cancelled:  # client gone, mid-prefill included
                        self._finish(self.engine.slots[slot_id])
            except Exception:  # noqa: BLE001 (the loop must survive)
                log.exception("request admission failed")
                time.sleep(0.05)
                continue
            try:
                with self.step_lock:
                    results = self.engine.step()
            except Exception as e:  # noqa: BLE001 (error every in-flight request, keep serving)
                log.exception("engine step failed")
                for slot_id, req in list(self.by_slot.items()):
                    req.emit(("error", f"engine: {type(e).__name__}: {e}"))
                    self.by_slot.pop(slot_id, None)
                    self.engine.release(self.engine.slots[slot_id])
                continue
            if not results and not self.by_slot:
                time.sleep(0.005)
                continue
            for slot, token, finished in results:
                req = self.by_slot.get(slot.id)
                if req is None or req.cancelled:
                    self._finish(slot)
                    continue
                req.emit(("token", token))
                if finished:
                    self._finish(slot)


# -----------------------------------------------------------------------------
# HTTP layer
# -----------------------------------------------------------------------------


class BadRequest(Exception):
    """A request the server refuses with HTTP 400."""


# body fields of features the port does not serve -> the name in the 400
_UNSUPPORTED_FIELDS = {
    "grammar": "grammar", "json_schema": "json_schema",
    "response_format": "response_format", "logprobs": "logprobs",
    "top_logprobs": "logprobs", "n_probs": "n_probs", "lora": "lora",
    "tools": "tools", "tool_choice": "tools",
}
_UNSUPPORTED_PATHS = {
    "/embedding": "embeddings", "/embeddings": "embeddings",
    "/v1/embeddings": "embeddings", "/rerank": "rerank", "/v1/rerank": "rerank",
    "/reranking": "rerank", "/v1/reranking": "rerank", "/infill": "infill",
    "/props": "POST /props",
}


def _refuse_unsupported(body: dict) -> None:
    for key, feature in _UNSUPPORTED_FIELDS.items():
        value = body.get(key)
        if key == "response_format" and value == {"type": "text"}:
            continue  # plain text is what every request returns
        if value not in (None, False, 0, "", [], {}):
            raise BadRequest(f"{feature} is not supported by this server")


def _partial_stop(text: str, stops: list[str]) -> int:
    """Length of the longest tail of ``text`` that begins a stop string: a
    stream holds it back until the next token decides."""
    n = 0
    for s in stops:
        for k in range(min(len(s) - 1, len(text)), n, -1):
            if text.endswith(s[:k]):
                n = k
                break
    return n


def _sampler_from_body(body: dict) -> SamplerConfig:
    seed = body.get("seed")
    return SamplerConfig(
        temp=float(body.get("temperature", 0.8)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.05)),
        penalty_repeat=float(body.get("repeat_penalty",
                                      body.get("frequency_penalty", 0.0) + 1.0 or 1.0)),
        seed=None if seed is None or int(seed) < 0 else int(seed),
    )


def make_server(srv: InferenceServer, host: str = "127.0.0.1", port: int = 8080,
                api_key: str | None = None) -> ThreadingHTTPServer:
    """An HTTP server bound to (host, port) (port 0: any free port) that
    serves ``srv``; call ``serve_forever`` on it (and ``srv.start()``)."""
    eng = srv.engine
    tok = eng.tokenizer

    class Handler(BaseHTTPRequestHandler):
        server_version = "llama-server-torch"

        def log_message(self, fmt, *args):  # quiet: one line per request at debug
            log.debug("%s " + fmt, self.address_string(), *args)

        # -- plumbing -----------------------------------------------------

        def _json(self, obj, status: int = 200):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _text(self, text: str, status: int = 200):
            data = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, status: int, message: str):
            self._json({"error": {"code": status, "message": message}}, status)

        def _authorized(self) -> bool:
            if not api_key or self.path == "/health":
                return True
            auth = self.headers.get("Authorization", "")
            if auth == f"Bearer {api_key}":
                return True
            self._error(401, "Invalid API Key")
            return False

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise BadRequest(f"invalid JSON body: {e}") from e
            if not isinstance(body, dict):
                raise BadRequest("the body must be a JSON object")
            return body

        def do_GET(self):
            if not self._authorized():
                return
            routes = {"/health": health, "/props": props, "/metrics": metrics,
                      "/slots": slots, "/models": models, "/v1/models": models}
            fn = routes.get(self.path.split("?", 1)[0])
            if fn is None:
                self._error(404, f"no such endpoint: GET {self.path}")
                return
            fn(self)

        def do_POST(self):
            if not self._authorized():
                return
            path = self.path.split("?", 1)[0]
            routes = {"/tokenize": tokenize, "/detokenize": detokenize,
                      "/completion": completions, "/completions": completions,
                      "/v1/completions": completions,
                      "/chat/completions": chat_completions,
                      "/v1/chat/completions": chat_completions}
            try:
                if path in _UNSUPPORTED_PATHS or path.startswith("/slots/"):
                    feature = _UNSUPPORTED_PATHS.get(path, "slot save/restore")
                    raise BadRequest(f"{feature} is not supported by this server")
                fn = routes.get(path)
                if fn is None:
                    self._error(404, f"no such endpoint: POST {path}")
                    return
                fn(self, self._body())
            except BadRequest as e:
                self._error(400, str(e))
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away

    # -- generation ----------------------------------------------------------

    def make_req(prompt_ids, body) -> PendingRequest:
        _refuse_unsupported(body)
        try:
            n_predict = int(body.get("n_predict", body.get("max_tokens", 128)) or 128)
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            req = PendingRequest(
                prompt_ids, n_predict, _sampler_from_body(body), list(stop),
                n_keep=int(body.get("n_keep", srv.default_n_keep) or 0),
                truncate=bool(body.get("truncate", True)))
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad request field: {e}") from e
        srv.submit(req)
        return req

    def collect_or_stream(h, req: PendingRequest, stream: bool, fmt):
        """fmt(text_delta, finished, reason) -> one SSE chunk.  Streams the
        chunks (the last one with ``timings``), or returns (text, token ids,
        finish reason, timings).  Timings: ``ttft_ms`` from the request's
        arrival (slot wait, prefill, first sample) to its first token,
        ``predicted_ms`` from there to the end, ``predicted_n`` tokens."""
        if stream:
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            h.end_headers()

        def send(obj):
            h.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            h.wfile.flush()

        pieces: list[int] = []
        emitted = 0
        text = ""
        reason = "stop"
        t_first = None
        try:
            while True:
                try:
                    kind, value = req.token_queue.get(timeout=srv.timeout)
                except queue.Empty:
                    req.cancelled = True
                    reason = "timeout"
                    break
                if kind == "error":
                    req.cancelled = True
                    if stream:
                        send({"error": value})
                        return None
                    raise BadRequest(value)
                if kind == "done":
                    reason = value["reason"]
                    break
                pieces.append(value)
                if t_first is None:
                    t_first = time.perf_counter()
                text = tok.detokenize(pieces)
                for s in req.stop_strings:
                    if s and s in text:
                        text = text[: text.index(s)]
                        req.cancelled = True
                        reason = "stop"
                        break
                if req.cancelled:
                    break
                # hold back a possible stop string's start and a possibly
                # partial multibyte character
                end = len(text) - _partial_stop(text, req.stop_strings)
                delta = text[emitted:end]
                if stream and delta and not delta.endswith("\ufffd"):
                    send(fmt(delta, False, None))
                    emitted = end
            t_end = time.perf_counter()
            timings = {"ttft_ms": None if t_first is None else (t_first - req.t_arrival) * 1e3,
                       "predicted_ms": None if t_first is None else (t_end - t_first) * 1e3,
                       "predicted_n": len(pieces)}
            if stream:
                send({**fmt(text[emitted:], True, reason), "timings": timings})
                h.wfile.write(b"data: [DONE]\n\n")
                h.wfile.flush()
                return None
        except (BrokenPipeError, ConnectionResetError):
            req.cancelled = True
            raise
        return text, pieces, reason, timings

    # -- endpoints ----------------------------------------------------------

    def health(h):
        h._json({"status": "ok"})

    def props(h):
        h._json({"model": srv.model_name, "n_ctx": eng.max_seq,
                 "n_slots": eng.n_slots, "arch": eng.cfg.arch,
                 "n_vocab": eng.cfg.n_vocab,
                 "chat_template": tok.vocab.chat_template or ""})

    def models(h):
        h._json({"object": "list", "data": [{
            "id": srv.model_name, "object": "model", "created": int(srv.t_start),
            "owned_by": "llama_cpp_gfx906_tpu_torch"}]})

    def metrics(h):
        m = eng.metrics
        with srv.step_lock:
            launches = kernels.device_counts()
        lines = [
            "# TYPE llamacpp_tpu:prompt_tokens_total counter",
            f"llamacpp_tpu:prompt_tokens_total {m['n_prompt_tokens']}",
            "# TYPE llamacpp_tpu:prompt_tokens_cached_total counter",
            f"llamacpp_tpu:prompt_tokens_cached_total {m['n_prompt_tokens_cached']}",
            "# TYPE llamacpp_tpu:tokens_predicted_total counter",
            f"llamacpp_tpu:tokens_predicted_total {m['n_generated_tokens']}",
            "# TYPE llamacpp_tpu:requests_total counter",
            f"llamacpp_tpu:requests_total {m['n_requests']}",
            "# TYPE llamacpp_tpu:prompt_seconds_total counter",
            f"llamacpp_tpu:prompt_seconds_total {m['t_prefill_s']:.6f}",
            "# TYPE llamacpp_tpu:predicted_seconds_total counter",
            f"llamacpp_tpu:predicted_seconds_total {m['t_decode_s']:.6f}",
            "# TYPE llamacpp_tpu:predicted_device_seconds_total counter",
            f"llamacpp_tpu:predicted_device_seconds_total {m['t_decode_device_s']:.6f}",
            "# TYPE llamacpp_tpu:decode_steps_total counter",
            f"llamacpp_tpu:decode_steps_total {m['n_decode_steps']}",
            "# TYPE llamacpp_tpu:prefill_chunks_total counter",
            f"llamacpp_tpu:prefill_chunks_total {m['n_prefill_chunks']}",
            "# TYPE llamacpp_tpu:slots_busy gauge",
            f"llamacpp_tpu:slots_busy {eng.n_active}",
            "# TYPE llamacpp_tpu:slots_idle gauge",
            f"llamacpp_tpu:slots_idle {eng.n_slots - eng.n_active}",
            "# TYPE llamacpp_tpu:kernel_launches_total counter",
        ]
        lines += [f'llamacpp_tpu:kernel_launches_total{{kernel="{k}"}} {v}'
                  for k, v in sorted(launches.items())]
        h._text("\n".join(lines) + "\n")

    def slots(h):
        h._json([{"id": s.id, "state": s.state.name, "n_past": s.n_past,
                  "n_generated": len(s.generated), "request_id": s.request_id}
                 for s in eng.slots])

    def tokenize(h, body):
        ids = tok.tokenize(str(body.get("content", "")),
                           add_special=bool(body.get("add_special", False)),
                           parse_special=bool(body.get("parse_special", True)))
        h._json({"tokens": ids})

    def detokenize(h, body):
        ids = body.get("tokens", [])
        if not isinstance(ids, list) or not all(
                isinstance(t, int) and 0 <= t < eng.cfg.n_vocab for t in ids):
            raise BadRequest("tokens must be a list of token ids")
        h._json({"content": tok.detokenize(ids)})

    def completions(h, body):
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            if not all(isinstance(t, int) for t in prompt):
                raise BadRequest("a list prompt must hold token ids")
            prompt_ids = list(prompt)
        elif isinstance(prompt, str):
            prompt_ids = tok.tokenize(prompt, add_special=True, parse_special=True)
        else:
            raise BadRequest("prompt must be a string or a list of token ids")
        try:
            n_choices = max(1, int(body.get("n", 1) or 1))
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad n: {e}") from e
        rid = f"cmpl-{uuid.uuid4().hex[:12]}"
        stream = bool(body.get("stream", False))
        if stream and n_choices > 1:
            raise BadRequest("streaming supports n=1")

        def fmt(delta, finished, reason):
            return {"id": rid, "object": "text_completion",
                    "created": int(time.time()), "model": srv.model_name,
                    "choices": [{"index": 0, "text": delta,
                                 "finish_reason": reason if finished else None}]}

        reqs = [make_req(prompt_ids, body) for _ in range(n_choices)]
        if stream:
            collect_or_stream(h, reqs[0], True, fmt)
            return
        choices, n_out = [], 0
        for i, req in enumerate(reqs):
            text, pieces, reason, timings = collect_or_stream(h, req, False, fmt)
            n_out += len(pieces)
            choices.append({"index": i, "text": text, "finish_reason": reason,
                            "timings": timings})
        h._json({"id": rid, "object": "text_completion", "created": int(time.time()),
                 "model": srv.model_name, "choices": choices,
                 "usage": {"prompt_tokens": len(prompt_ids), "completion_tokens": n_out,
                           "total_tokens": len(prompt_ids) + n_out}})

    def chat_completions(h, body):
        from ..chat import render_chat_template

        messages = body.get("messages", [])
        if not isinstance(messages, list) or not all(isinstance(m, dict) for m in messages):
            raise BadRequest("messages must be a list of objects")
        flat = []
        for m in messages:
            c = m.get("content")
            if isinstance(c, list):  # content parts: text only
                if any(isinstance(p, dict) and p.get("type") not in (None, "text")
                       for p in c):
                    raise BadRequest("image and other non-text content parts are "
                                     "not supported by this server")
                c = "".join(str(p.get("text", "")) for p in c if isinstance(p, dict))
            flat.append({**m, "content": c})
        _refuse_unsupported(body)
        v = tok.vocab
        bos = v.tokens[v.special.bos] if v.special.bos is not None else ""
        eos = v.tokens[v.special.eos] if v.special.eos is not None else ""
        prompt = render_chat_template(v.chat_template, flat, add_generation_prompt=True,
                                      bos_token=bos, eos_token=eos)
        prompt_ids = tok.tokenize(prompt, add_special=True, parse_special=True)
        req = make_req(prompt_ids, body)
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        stream = bool(body.get("stream", False))

        def fmt(delta, finished, reason):
            d = {} if finished and not delta else {"content": delta}
            return {"id": rid, "object": "chat.completion.chunk",
                    "created": int(time.time()), "model": srv.model_name,
                    "choices": [{"index": 0, "delta": d,
                                 "finish_reason": reason if finished else None}]}

        if stream:
            collect_or_stream(h, req, True, fmt)
            return
        text, pieces, reason, timings = collect_or_stream(h, req, False, fmt)
        h._json({"id": rid, "object": "chat.completion", "created": int(time.time()),
                 "model": srv.model_name,
                 "choices": [{"index": 0, "message": {"role": "assistant", "content": text},
                              "finish_reason": reason, "timings": timings}],
                 "usage": {"prompt_tokens": len(prompt_ids),
                           "completion_tokens": len(pieces),
                           "total_tokens": len(prompt_ids) + len(pieces)}})

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="llama-server-torch",
        description="OpenAI-compatible continuous-batching server on the "
                    "PyTorch/CUDA port (the JAX server's flag names)")
    ap.add_argument("-m", "--model", required=True, help="model GGUF path")
    ap.add_argument("-c", "--ctx-size", dest="ctx_size", type=int, default=2048,
                    help="context window per slot (tokens)")
    ap.add_argument("-np", "--parallel", dest="n_slots", type=int, default=4,
                    help="concurrent request slots")
    ap.add_argument("-b", "--batch-size", dest="n_batch", type=int, default=256,
                    help="prompt tokens per prefill chunk")
    ap.add_argument("-ctk", "--cache-type-k", dest="cache_type_k",
                    choices=("f32", "bf16", "q8"), default=None,
                    help="KV cache storage type (default bf16; q8 halves it)")
    ap.add_argument("--host", default="127.0.0.1", help="bind address")
    ap.add_argument("--port", type=int, default=8080, help="port (0: any free)")
    ap.add_argument("-a", "--alias", default=None, help="model name in the API")
    ap.add_argument("--api-key", dest="api_key", default=None,
                    help="require this bearer token (not for /health)")
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds to wait for each token")
    ap.add_argument("--keep", "--n-keep", dest="n_keep", type=int, default=0,
                    help="prompt tokens kept by the context shift")
    ap.add_argument("--no-warmup", dest="no_warmup", action="store_true",
                    help="skip the warmup request")
    ap.add_argument("--no-context-shift", dest="no_ctx_shift", action="store_true",
                    help="stop at the context end instead of shifting")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def main(argv=None) -> int:
    import torch

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    kv_dtype = {None: None, "bf16": torch.bfloat16, "f32": torch.float32,
                "q8": "q8"}[args.cache_type_k]
    engine = BatchedEngine.from_gguf(
        args.model, device=args.device, n_slots=args.n_slots,
        max_seq=args.ctx_size, n_chunk=args.n_batch,
        ctx_shift=not args.no_ctx_shift, kv_cache_dtype=kv_dtype)
    if not args.no_warmup:
        engine.warmup()
    srv = InferenceServer(engine, model_name=args.alias or args.model.rsplit("/", 1)[-1])
    srv.timeout = max(args.timeout, 1)
    srv.default_n_keep = args.n_keep
    srv.start()
    httpd = make_server(srv, args.host, args.port, args.api_key)
    log.info("listening on http://%s:%d", *httpd.server_address[:2])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's HTTP server (llama_cpp_gfx906_tpu_torch.server) on the CPU.

The server runs in a thread on port 0 over the committed tinydoc fixture (a
2-slot BatchedEngine at f32) and is driven with urllib: every ported
endpoint, greedy text equal to the pinned tinydoc tokens, server-sent
events ending in ``[DONE]``, stop strings, ``n`` choices, the API key, the
``/metrics`` counters, and HTTP 400 naming each feature the port lacks.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine
from llama_cpp_gfx906_tpu_torch.server.app import InferenceServer, build_parser, make_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
KEY = "sekrit"


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIX, "tinydoc_expected.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def server():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    eng = BatchedEngine.from_gguf(os.path.join(FIX, "tinydoc-byte.f16.gguf"),
                                  dtype=torch.float32, device="cpu", n_slots=2,
                                  max_seq=128, n_chunk=16)
    srv = InferenceServer(eng, model_name="tiny")
    srv.start()
    httpd = make_server(srv, "127.0.0.1", 0, api_key=KEY)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", eng
    httpd.shutdown()
    httpd.server_close()
    srv.stop()
    torch.set_num_threads(n)


def call(base, path, body=None, key=KEY, raw=False):
    """(status, parsed JSON body, or the raw text with ``raw``)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST")
    if key:
        req.add_header("Authorization", f"Bearer {key}")
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    return status, (text if raw else json.loads(text))


def events(text):
    """The ``data:`` payloads of a server-sent event stream."""
    return [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]


def greedy_text(server, expected, prompt, n):
    eng = server[1]
    return eng.tokenizer.detokenize(expected["greedy"][prompt][:n])


def test_get_endpoints(server):
    base, eng = server
    assert call(base, "/health", key=None) == (200, {"status": "ok"})
    status, props = call(base, "/props")
    assert status == 200 and props["n_slots"] == 2 and props["n_ctx"] == 128
    for path in ("/models", "/v1/models"):
        status, body = call(base, path)
        assert status == 200 and body["data"][0]["id"] == "tiny"
    status, slots = call(base, "/slots")
    assert status == 200 and [s["id"] for s in slots] == [0, 1]
    assert call(base, "/nowhere")[0] == 404


def test_api_key_is_required(server):
    base, _ = server
    assert call(base, "/props", key=None)[0] == 401
    assert call(base, "/props", key="wrong")[0] == 401
    assert call(base, "/v1/completions", {"prompt": "a"}, key=None)[0] == 401


def test_tokenize_detokenize_round_trip(server):
    base, eng = server
    status, body = call(base, "/tokenize", {"content": "quant"})
    assert status == 200
    assert body["tokens"] == eng.tokenizer.tokenize("quant", add_special=False,
                                                    parse_special=True)
    text = call(base, "/detokenize", {"tokens": body["tokens"]})[1]["content"]
    assert text == eng.tokenizer.detokenize(body["tokens"]) and text.endswith("quant")
    assert call(base, "/detokenize", {"tokens": [10 ** 9]})[0] == 400


@pytest.mark.parametrize("path", ["/completion", "/completions", "/v1/completions"])
def test_completion_greedy_is_the_pinned_text(server, expected, path):
    """Greedy completions of text and of token-id prompts give the pinned
    tinydoc tokens' text; usage counts the tokens."""
    base, eng = server
    want = greedy_text(server, expected, "The ", 10)
    body = {"prompt": "The ", "n_predict": 10, "temperature": 0.0}
    status, out = call(base, path, body)
    assert status == 200, out
    assert out["choices"][0]["text"] == want
    assert out["choices"][0]["finish_reason"] == "length"
    timings = out["choices"][0]["timings"]
    assert timings["predicted_n"] == 10 and 0 < timings["ttft_ms"] < 60e3
    ids = eng.tokenizer.tokenize("The ", add_special=True, parse_special=True)
    assert out["usage"] == {"prompt_tokens": len(ids), "completion_tokens": 10,
                            "total_tokens": len(ids) + 10}
    status, out2 = call(base, path, {**body, "prompt": ids, "max_tokens": 10})
    assert status == 200 and out2["choices"][0]["text"] == want


def test_n_choices_and_concurrent_requests(server, expected):
    base, _ = server
    body = {"prompt": "# ", "max_tokens": 6, "temperature": 0.0, "n": 3}
    status, out = call(base, "/v1/completions", body)
    want = greedy_text(server, expected, "# ", 6)
    assert status == 200 and [c["text"] for c in out["choices"]] == [want] * 3
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    results = [None] * 4
    prompts = ["The ", "# ", "quant", "The "]

    def one(i):
        results[i] = call(base, "/completion", {"prompt": prompts[i], "n_predict": 5,
                                                "temperature": 0.0})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for p, (status, out) in zip(prompts, results):
        assert status == 200 and out["choices"][0]["text"] == greedy_text(
            server, expected, p, 5)


@pytest.mark.parametrize("path", ["/v1/completions", "/v1/chat/completions"])
def test_stream_ends_in_done_and_equals_the_whole(server, path):
    base, _ = server
    if "chat" in path:
        body = {"messages": [{"role": "user", "content": "quant"}]}
    else:
        body = {"prompt": "quant"}
    body.update(max_tokens=8, temperature=0.0)
    status, whole = call(base, path, body)
    assert status == 200
    status, text = call(base, path, {**body, "stream": True}, raw=True)
    ev = events(text)
    assert status == 200 and ev[-1] == "[DONE]"
    chunks = [json.loads(e)["choices"][0] for e in ev[:-1]]
    assert chunks[-1]["finish_reason"] == "length"
    assert json.loads(ev[-2])["timings"]["predicted_n"] == 8
    assert all(c["finish_reason"] is None for c in chunks[:-1])
    if "chat" in path:
        streamed = "".join(c["delta"].get("content", "") for c in chunks)
        assert whole["choices"][0]["message"] == {"role": "assistant", "content": streamed}
        assert whole["object"] == "chat.completion"
    else:
        streamed = "".join(c["text"] for c in chunks)
        assert whole["choices"][0]["text"] == streamed


def test_stop_string_cuts_the_text(server, expected):
    base, _ = server
    full = greedy_text(server, expected, "# ", 24)
    stop = full[8:11]
    cut = full[: full.index(stop)]
    body = {"prompt": "# ", "n_predict": 24, "temperature": 0.0, "stop": [stop]}
    status, out = call(base, "/completion", body)
    choice = out["choices"][0]
    assert status == 200 and (choice["text"], choice["finish_reason"]) == (cut, "stop")
    status, text = call(base, "/completion", {**body, "stop": stop, "stream": True}, raw=True)
    chunks = [json.loads(e)["choices"][0] for e in events(text)[:-1]]
    assert "".join(c["text"] for c in chunks) == cut
    assert chunks[-1]["finish_reason"] == "stop"


def test_seeded_sampling_repeats(server):
    base, _ = server
    body = {"prompt": "The ", "n_predict": 8, "temperature": 0.8, "seed": 42}
    a, b = call(base, "/completion", body), call(base, "/completion", body)
    assert a[0] == 200 and a[1]["choices"][0]["text"] == b[1]["choices"][0]["text"]


def test_metrics_count_the_tokens(server):
    base, _ = server

    def counters():
        status, text = call(base, "/metrics", raw=True)
        assert status == 200
        return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
                if ln and not ln.startswith("#")}

    before = counters()
    _, out = call(base, "/v1/completions", {"prompt": "quant", "max_tokens": 7,
                                            "temperature": 0.0, "n": 2})
    after = counters()
    assert after["llamacpp_tpu:requests_total"] - before["llamacpp_tpu:requests_total"] == 2
    assert (after["llamacpp_tpu:tokens_predicted_total"]
            - before["llamacpp_tpu:tokens_predicted_total"]) == 2 * 7 == \
        out["usage"]["completion_tokens"]
    assert (after["llamacpp_tpu:prompt_tokens_total"]
            - before["llamacpp_tpu:prompt_tokens_total"]) == 2 * out["usage"]["prompt_tokens"]
    assert after["llamacpp_tpu:slots_idle"] == 2


def test_metrics_count_steps_chunks_and_launches(server):
    """/metrics counts the engine's prefill chunks and decode steps, and
    lists every kernel's device launch count (0 on the CPU, where the plain
    versions run) and the decode replays' device time (0 on the CPU)."""
    base, _ = server

    def counters():
        text = call(base, "/metrics", raw=True)[1]
        return {ln.split()[0].split(":", 1)[1]: float(ln.split()[1])
                for ln in text.splitlines() if ln and not ln.startswith("#")}

    before = counters()
    prompt = [7] + list(range(40, 79))  # 40 new tokens: 16 + 16 + 8 on the chunk grid
    status, _ = call(base, "/v1/completions", {"prompt": prompt, "max_tokens": 5,
                                               "temperature": 0.0})
    after = counters()
    d = {k: after[k] - before[k] for k in after}
    assert status == 200
    assert (d["prefill_chunks_total"], d["decode_steps_total"]) == (3, 4)
    assert after["predicted_device_seconds_total"] == 0
    kernels = {k for k in after if k.startswith("kernel_launches_total{")}
    assert {'kernel_launches_total{kernel="flash_decode_int8"}',
            'kernel_launches_total{kernel="decode_stream"}'} <= kernels
    assert all(after[k] == 0 for k in kernels)


UNSUPPORTED_BODIES = [
    ("grammar", {"grammar": "root ::= \"a\""}),
    ("json_schema", {"json_schema": {"type": "object"}}),
    ("response_format", {"response_format": {"type": "json_object"}}),
    ("logprobs", {"logprobs": 2}),
    ("n_probs", {"n_probs": 3}),
    ("lora", {"lora": [{"id": 0, "scale": 1.0}]}),
    ("tools", {"tools": [{"type": "function", "function": {"name": "f"}}]}),
]


@pytest.mark.parametrize("feature,extra", UNSUPPORTED_BODIES, ids=[f for f, _ in UNSUPPORTED_BODIES])
@pytest.mark.parametrize("path", ["/completion", "/v1/chat/completions"])
def test_unsupported_fields_are_refused(server, feature, extra, path):
    base, _ = server
    body = ({"messages": [{"role": "user", "content": "hi"}]} if "chat" in path
            else {"prompt": "hi"})
    status, out = call(base, path, {**body, "max_tokens": 2, **extra})
    assert status == 400 and feature in out["error"]["message"]


@pytest.mark.parametrize("path,feature", [
    ("/v1/embeddings", "embeddings"), ("/embedding", "embeddings"), ("/rerank", "rerank"),
    ("/infill", "infill"), ("/props", "POST /props"), ("/slots/0?action=save", "slot"),
])
def test_unsupported_endpoints_are_refused(server, path, feature):
    status, out = call(server[0], path, {"input": "hi"})
    assert status == 400 and feature in out["error"]["message"]


def test_image_parts_and_bad_bodies_are_refused(server):
    base, _ = server
    image = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "hi"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA=="}}]}]}
    status, out = call(base, "/v1/chat/completions", image)
    assert status == 400 and "image" in out["error"]["message"]
    assert call(base, "/completion", {"prompt": {"a": 1}})[0] == 400
    assert call(base, "/completion", {"prompt": [1, "x"]})[0] == 400
    assert call(base, "/completion", {"prompt": "hi", "n_predict": "many"})[0] == 400
    # a text response format is what the server returns anyway
    status, _ = call(base, "/completion", {"prompt": "hi", "n_predict": 1,
                                           "response_format": {"type": "text"}})
    assert status == 200


def test_parser_takes_the_jax_flag_names():
    args = build_parser().parse_args(
        ["-m", "x.gguf", "-c", "4096", "-np", "4", "-b", "128", "-ctk", "q8", "--host",
         "0.0.0.0", "--port", "0", "-a", "m", "--api-key", "k", "--timeout", "9",
         "--keep", "3", "--no-warmup", "--no-context-shift", "--device", "cpu"])
    assert (args.ctx_size, args.n_slots, args.n_batch, args.cache_type_k) == (4096, 4, 128, "q8")
    assert (args.alias, args.api_key, args.timeout, args.n_keep) == ("m", "k", 9, 3)
    assert args.no_warmup and args.no_ctx_shift and args.device == "cpu"

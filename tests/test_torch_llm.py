"""The port's LLM layer against the JAX package's (CPU): `JSONParser`,
`LLMClient` (retries, `chat_json`'s clarification turns, streaming, stats),
`MockLLMBackend`, `create_llm_backend`, and `OpenAICompatibleLLMBackend`
(chat and Server-Sent-Events stream) against a local `http.server` stub on
127.0.0.1. Outputs are host values: equal exactly.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from radiant_rag_tpu import config as jcfg
from radiant_rag_tpu.llm import backends as jb
from radiant_rag_tpu.llm.client import LLMClient as JaxClient
from radiant_rag_tpu.llm.json_parser import JSONParser as JaxParser
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.llm import backends as tb
from radiant_rag_tpu_torch.llm.client import LLMClient
from radiant_rag_tpu_torch.llm.json_parser import JSONParser

PKGS = {"jax": (jcfg, jb, JaxClient), "torch": (tcfg, tb, LLMClient)}

MALFORMED = [
    'Here:\n```json\n{"a": 1}\n```\ndone',
    'noise {"a": 1, // note\n "b": [1,2,],} tail',
    '{"items": [{"x": 1}, {"y": 2',
    '{"text": "unterminated',
    '[1,2,3]',
    'no json here',
    '',
    '{"url": "http://example.org/a", // c\n "k": 2}',
    '[{"sources": ["1"], "confidence": 0.8}, {"sources": [',
    '```\n[1, 2,]\n```',
    '{"a": {"b": [1, {"c": "d\\"e"}',
    'prefix [ "x", "y" ] and {"z": 1}',
    '{"a": 1}}}',
    '{"a":',
    'true',
    '{"nested": "a // not a comment"}',
]


@pytest.mark.parametrize("text", MALFORMED)
@pytest.mark.parametrize("expect", [None, dict, list])
def test_json_parser_matches_jax(text, expect):
    assert JSONParser.parse(text, expect=expect) == JaxParser.parse(text, expect=expect)
    assert JSONParser.extract_candidate(text) == JaxParser.extract_candidate(text)
    assert JSONParser.clean(text) == JaxParser.clean(text)
    assert JSONParser.repair_truncation(text) == JaxParser.repair_truncation(text)


def _both(fn):
    out = {name: fn(*mods) for name, mods in PKGS.items()}
    assert out["torch"] == out["jax"], out
    return out["torch"]


def test_chat_json_clarification_turns_match_jax():
    def run(cfg, b, Client):
        backend = b.MockLLMBackend(responder=lambda msgs: (
            "not json at all" if len(msgs) <= 3 else '{"fixed": true}'))
        client = Client(backend=backend)
        out = client.chat_json([{"role": "user", "content": "give json"}])
        none = Client(backend=b.MockLLMBackend(default="never json")).chat_json(
            [{"role": "user", "content": "x"}], expect=list, max_parse_retries=1)
        return out, backend.calls, none, client.stats()

    out, calls, none, stats = _both(run)
    assert out == {"fixed": True} and len(calls) == 3 and none is None
    assert calls[-1][-1]["content"].startswith("That was not valid JSON")


@pytest.mark.parametrize("status,calls", [(503, 3), (429, 3), (None, 3), (401, 1), (404, 1)])
def test_retries_match_jax(status, calls):
    def run(cfg, b, Client):
        class Flaky(b.BaseLLMBackend):
            def __init__(self):
                self.n = 0

            def chat(self, messages, **kw):
                self.n += 1
                if self.n < 3:
                    raise b.LLMError(f"HTTP {status}", status=status)
                return "recovered"

        client = Client(cfg.LLMConfig(retry_backoff_s=0.0), backend=Flaky())
        try:
            out = client.chat([{"role": "user", "content": "x"}])
        except b.LLMError as exc:
            out = ("raised", str(exc), exc.status, exc.retryable)
        return out, client.backend.n, client.stats()

    out, n, stats = _both(run)
    assert n == calls and (out == "recovered") == (calls == 3)


def test_stream_and_generate_match_jax():
    def run(cfg, b, Client):
        backend = b.MockLLMBackend(default="one two three")
        client = Client(backend=backend)
        tokens = []
        text = client.chat_stream([{"role": "user", "content": "x"}], on_token=tokens.append)
        gen = client.generate("p", system="s")
        default_stream = list(b.BaseLLMBackend.chat_stream(backend, [{"role": "user",
                                                                      "content": "y"}]))
        return text, tokens, gen, backend.calls, default_stream, backend.ping(), client.stats()

    text, tokens, gen, calls, default_stream, ping, stats = _both(run)
    assert tokens == ["one ", "two ", "three"] and text == "one two three"
    assert calls[1] == [{"role": "system", "content": "s"}, {"role": "user", "content": "p"}]


def test_stream_retries_only_before_the_first_token_like_jax():
    def run(cfg, b, Client):
        class Mid(b.BaseLLMBackend):
            def __init__(self):
                self.n = 0

            def chat(self, messages, **kw):
                return "x"

            def chat_stream(self, messages, **kw):
                self.n += 1
                if self.n == 1:
                    raise b.LLMError("503", status=503)
                yield "partial "
                raise b.LLMError("503", status=503)

        client = Client(cfg.LLMConfig(retry_backoff_s=0.0), backend=Mid())
        tokens = []
        with pytest.raises(b.LLMError):
            client.chat_stream([{"role": "user", "content": "x"}], on_token=tokens.append)
        return client.backend.n, tokens, client.stats()

    n, tokens, stats = _both(run)
    assert n == 2 and tokens == ["partial "]


def test_backend_factory_matches_jax_and_local_waits_for_weights():
    for backend in ("openai_compatible", "mock", "nope"):
        def run(cfg, b, Client, backend=backend):
            try:
                return type(b.create_llm_backend(cfg.LLMConfig(backend=backend))).__name__
            except ValueError as exc:
                return str(exc)

        _both(run)
    with pytest.raises(NotImplementedError, match="causal-LM weights.*item 11 \\(rest\\)"):
        tb.create_llm_backend(tcfg.LLMConfig(backend="local"))
    with pytest.raises(NotImplementedError, match="causal-LM weights"):
        LLMClient(tcfg.LLMConfig(backend="local"))


class _Stub(BaseHTTPRequestHandler):
    """An OpenAI-compatible chat endpoint: echoes the request's last message
    (non-stream), streams it word by word as SSE chunks, or fails with the
    status named in the message ("fail 401")."""

    requests = []

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        _Stub.requests.append((self.path, self.headers.get("Authorization"), body))
        last = body["messages"][-1]["content"]
        if last.startswith("fail "):
            self.send_response(int(last.split()[1]))
            self.end_headers()
            return
        if last == "malformed":
            data = json.dumps({"choices": []}).encode()
        elif body.get("stream"):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            for w in last.split(" "):
                self.wfile.write(f"data: {json.dumps({'choices': [{'delta': {'content': w + '|'}}]})}"
                                 "\n\n".encode())
            self.wfile.write(b": keep-alive\n\ndata: {bad json\n\n")
            self.wfile.write(b'data: {"choices": [{"delta": {}}]}\n\ndata: [DONE]\n\n')
            return
        else:
            data = json.dumps({"choices": [{"message": {"content": f"echo: {last}"}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def stub():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/v1/"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_openai_compatible_backend_matches_jax(stub):
    def run(cfg, b, Client):
        conf = cfg.LLMConfig(base_url=stub, api_key="k", model="m", timeout_s=10,
                             max_retries=0, retry_backoff_s=0)
        backend = b.OpenAICompatibleLLMBackend(conf)
        _Stub.requests.clear()
        out = [backend.chat([{"role": "user", "content": "hello there"}], temperature=0.5,
                            max_tokens=7),
               list(backend.chat_stream([{"role": "user", "content": "a b c"}]))]
        for msg in ("fail 401", "fail 500", "malformed"):
            try:
                backend.chat([{"role": "user", "content": msg}])
            except b.LLMError as exc:
                out.append((str(exc)[:40], exc.status, exc.retryable))
        try:
            list(backend.chat_stream([{"role": "user", "content": "fail 429"}]))
        except b.LLMError as exc:
            out.append((str(exc), exc.status, exc.retryable))
        client = Client(conf, backend=backend)
        tokens = []
        out.append((client.chat_stream([{"role": "user", "content": "x y"}],
                                        on_token=tokens.append), tokens, backend.ping()))
        return out, list(_Stub.requests)

    out, requests = _both(run)
    assert out[0] == "echo: hello there" and out[1] == ["a|", "b|", "c|"]
    assert [o[1:] for o in out[2:6]] == [(401, False), (500, True), (None, True), (429, True)]
    path, auth, body = requests[0]
    assert path == "/v1/chat/completions" and auth == "Bearer k"
    assert body == {"model": "m", "messages": [{"role": "user", "content": "hello there"}],
                    "temperature": 0.5, "max_tokens": 7}
    assert requests[1][2]["stream"] is True

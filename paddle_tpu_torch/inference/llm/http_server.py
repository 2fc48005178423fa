"""HTTP/SSE front end for LLM serving.

The wire is JSON over HTTP with the engine's full request surface —
every sampling knob, constraint grammars, ``n>1``, stop strings,
logprobs — and token-delta streaming over Server-Sent Events, on the
:class:`~.engine.AsyncLLMEngine` submission path: handler threads only
parse, validate and queue (host work), and the engine's worker thread
is the only one that steps it on the device.

Endpoints::

    POST /v1/completions      JSON body (fields below)
    GET  /healthz             the engine's lifecycle_stats() as JSON

Request fields (unknown fields are a 400, so client typos fail loudly):
``prompt_ids`` (required, list of ints), ``max_new_tokens``,
``eos_token_id``, ``temperature``, ``seed``, ``deadline_ms``,
``top_k``, ``top_p``, ``min_p``, ``repetition_penalty``,
``presence_penalty``, ``frequency_penalty``, ``logit_bias``
({token_id: bias}), ``logprobs`` (top-N per token), ``stop`` (string or
list), ``grammar`` (a :func:`~.structured.grammar_from_spec` spec
dict), ``n``, ``adapter`` (a LoRA adapter id: this engine serves no
adapters, so any adapter is a 400 before admission), ``stream`` (bool).

Non-streaming responses carry ``completions`` — a list of ``n``
``{"index", "request_id", "output_ids", "finish_reason",
"matched_stop", "logprobs"}`` dicts (parent first).  With
``stream: true`` the response is ``text/event-stream``: zero or more
``data: {"delta_ids": [...], "index": 0}`` events as the parent's
tokens land (deltas poll the live request between engine steps — no
engine hook, no extra device sync), one final ``data: {...}`` event
shaped like the non-streaming body, then the ``data: [DONE]``
sentinel.  Validation errors are a 400 with ``{"error": message}``,
before any request is admitted.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine import AsyncLLMEngine
from .structured import grammar_from_spec

__all__ = ["HttpLLMServer"]

# every accepted POST /v1/completions field, in one place so the
# unknown-field 400 and the submit() call can't drift apart
_FIELDS = frozenset((
    "prompt_ids", "max_new_tokens", "eos_token_id", "temperature",
    "seed", "deadline_ms", "top_k", "top_p", "min_p",
    "repetition_penalty", "presence_penalty", "frequency_penalty",
    "logit_bias", "logprobs", "stop", "grammar", "n", "adapter",
    "stream",
))


def _completion_record(index, out):
    """One finished request as the wire's completion dict."""
    return {
        "index": index,
        "request_id": str(out.request_id),
        "output_ids": [int(t) for t in out.output_ids],
        "finish_reason": out.finish_reason,
        "matched_stop": out.matched_stop,
        "logprobs": (None if out.logprobs is None else
                     [{"logprob": lp, "top": [[t, l] for t, l in top]}
                      for lp, top in out.logprobs]),
    }


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------ plumbing --
    def log_message(self, fmt, *args):   # tests stay quiet
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _sse_event(self, obj):
        data = obj if isinstance(obj, str) else json.dumps(obj)
        self.wfile.write(f"data: {data}\n\n".encode())
        self.wfile.flush()

    # ------------------------------------------------------------ requests --
    def do_GET(self):
        if self.path != "/healthz":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        self._json(200, self.server.app.backend.lifecycle_stats())

    def do_POST(self):
        if self.path != "/v1/completions":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        app = self.server.app
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            unknown = set(body) - _FIELDS
            if unknown:
                raise ValueError(
                    f"unknown request fields: {sorted(unknown)}")
            if "prompt_ids" not in body:
                raise ValueError("prompt_ids is required")
            stream = bool(body.pop("stream", False))
            n = int(body.get("n", 1))
            spec = body.pop("grammar", None)
            if spec is not None:
                body["grammar"] = grammar_from_spec(
                    spec, vocab_size=app.vocab_size)
            # no adapter can be registered on this engine: any adapter
            # is unknown, a 400 with the engine left empty
            adapter = body.pop("adapter", None)
            if adapter is not None:
                raise ValueError(
                    f"unknown adapter {adapter!r}: this engine serves no "
                    f"LoRA adapters")
            prompt_ids = body.pop("prompt_ids")
            rid = app.submit(prompt_ids, **body)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
            return
        if stream:
            self._stream(app, rid, n)
        else:
            outs = app.collect(rid, n)
            self._json(200, {
                "request_id": str(rid),
                "completions": [_completion_record(i, o)
                                for i, o in enumerate(outs)],
            })

    def _stream(self, app, rid, n):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        # delta loop: poll the LIVE request's output_ids between engine
        # steps (list() snapshot under the GIL) until the finished
        # output is published; peeking _results under _cond — never
        # result(timeout=), which ABORTS on expiry
        last = 0
        while True:
            with app.async_engine._cond:
                done = app.async_engine._results.get(rid)
            if done is not None:
                ids = [int(t) for t in done.output_ids]
            else:
                req = app.backend._requests.get(rid)
                ids = list(req.output_ids) if req is not None else []
            if len(ids) > last:
                self._sse_event(
                    {"delta_ids": [int(t) for t in ids[last:]],
                     "index": 0})
                last = len(ids)
            if done is not None:
                break
            # the backend's injected sleep (VirtualClock-aware), never
            # a raw wall-clock stall inside the delta poll loop
            getattr(app.backend, "_sleep", time.sleep)(app.poll_interval)
        outs = app.collect(rid, n)
        self._sse_event({
            "request_id": str(rid),
            "completions": [_completion_record(i, o)
                            for i, o in enumerate(outs)],
        })
        self._sse_event("[DONE]")


class HttpLLMServer:
    """Serve one engine over HTTP/SSE.

    >>> eng = LLMEngine(gpt_124m(dtype=torch.bfloat16), dtype="bfloat16")
    >>> eng.warmup()          # capture every bucket's graph first
    >>> srv = HttpLLMServer(engine=eng).start()
    >>> host, port = srv.address
    >>> ...  # POST http://host:port/v1/completions
    >>> srv.close()

    ``port=0`` binds an ephemeral port (read it back from
    ``.address``).  The server owns its AsyncLLMEngine (and joins it on
    close), so the engine passed here must not be stepped by anyone
    else.  ``fleet=`` (replicated serving) is not ported yet."""

    def __init__(self, engine=None, fleet=None, host="127.0.0.1",
                 port=0, poll_interval=0.005):
        if (engine is None) == (fleet is None):
            raise ValueError(
                "construct with exactly one of engine= or fleet=")
        if fleet is not None:
            raise NotImplementedError(
                "HttpLLMServer(fleet=...) is not ported yet: it comes "
                "with the fleet slice (ROADMAP A14)")
        self.backend = engine
        self.vocab_size = engine.vocab_size
        self.poll_interval = float(poll_interval)
        self.async_engine = AsyncLLMEngine(self.backend)
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.app = self
        self._thread = None

    @property
    def address(self):
        return self._httpd.server_address[:2]

    def submit(self, prompt_ids, **kwargs):
        return self.async_engine.submit(prompt_ids, **kwargs)

    def collect(self, rid, n):
        """Block for the fork family's outputs, parent first.  A child
        exists iff the parent emitted at least one token (forks split
        right before the first commit), so a shed/aborted-in-prefill
        parent returns alone instead of waiting on ghosts."""
        outs = [self.async_engine.result(rid)]
        if n > 1 and len(outs[0].output_ids):
            outs.extend(self.async_engine.result(f"{rid}.{k}")
                        for k in range(1, n))
        return outs

    def start(self):
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.async_engine.close()

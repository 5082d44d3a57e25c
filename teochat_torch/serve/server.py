"""Dependency-free HTTP serving endpoint (port of teochat_tpu/serve/server.py).

A stdlib ThreadingHTTPServer speaking JSON:

    POST /generate {"prompt": str, "images": [base64 PNG/JPEG, ...],
                    "timestamps": [...], "bbox": [x1,y1,x2,y2] | null,
                    "temperature": float, "max_new_tokens": int,
                    "session_id": str | null}
      -> {"response": str, "bboxes": [[x1,y1,x2,y2], ...]}
    POST /reset {"session_id": str | null} -> {"status": "reset"}
    GET /health -> {"status": "ok"}
    GET /stats -> {"mode": "session", "sessions": {session_id: the session's counters}},
                  or in engine mode {"mode": "continuous_batching", the engine's counters,
                  and with speculation "spec_mean_tokens_per_step"}

`session_id` gives each conversation its own multi-turn state (history,
frames, incremental KV session); an omitted or null one uses the default
session, as the reference demo's single session. Sessions beyond
`max_sessions` are evicted least recently used first (the default one
never); resetting an unknown session does nothing.

Two modes:
- default: requests go through one worker thread over stateful `Chat`
  sessions: every model call runs on that thread, so on one CUDA stream.
  The decode graphs and the kernels' shared ticket buffers
  (ops/_build.py::tickets_for) are safe on one stream only. A streamed
  request is answered 400.
- `engine=BatchEngine(...)` (serve/engine.py, started): a request without
  a session_id is stateless; its handler thread builds the first-turn
  prompt and submits it to the continuous-batching engine, which batches
  the decode of concurrent requests over one KV cache. With `"stream":
  true` it is answered by server-sent events, `data: {"token_ids", "text"}`
  a decode chunk, then `data: [DONE]`. Requests with a session_id still go
  through the worker thread, which holds the engine's `device_lock` for
  each of them: one thread at a time issues device work (a CUDA graph
  capture on one thread fails if another allocates or synchronizes during
  it). A stateful stream is answered 400.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_NO_LOCK = contextlib.nullcontext()


def _decode_images(b64_list):
    from PIL import Image

    images = []
    for b in b64_list:
        raw = base64.b64decode(b)
        images.append(np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")))
    return images


class ChatServer:
    """Serves serve.chat.Chat sessions (or compatible objects) over HTTP."""

    def __init__(self, chat, host: str = "127.0.0.1", port: int = 7860,
                 engine=None, max_sessions: int = 4, session_factory=None):
        self.chat = chat  # the default session ("")
        self.host = host
        self.port = port
        self.engine = engine  # serve.engine.BatchEngine (started), or None
        # a session's KV cache is allocated by its first turn (2 GiB at 7B
        # width and 4,096 slots in bf16), so max_sessions bounds the caches'
        # device memory at max_sessions times that; idle sessions hold none
        self.max_sessions = max_sessions
        self._session_factory = session_factory or self._clone_default_chat
        # per-conversation Chats by session_id; insertion order is LRU order
        self._sessions = {"": chat}
        self._jobs: "queue.Queue" = queue.Queue()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._worker_thread: Optional[threading.Thread] = None
        self._serve_thread: Optional[threading.Thread] = None

    def _clone_default_chat(self):
        """A new Chat with the default one's model and settings (incremental
        mode and session max_len included). A server over a Chat subclass
        with another __init__ passes `session_factory`."""
        kw = dict(
            model_bundle=(self.chat.tokenizer, self.chat.model, self.chat.processor),
            conv_mode=self.chat.conv_mode,
            incremental=self.chat._session is not None,
        )
        if self.chat._session is not None:
            kw["session_max_len"] = self.chat._session.max_len
        return type(self.chat)(**kw)

    def _session_for(self, session_id: str):
        """The Chat of a session id, made if new (worker thread only)."""
        chat = self._sessions.pop(session_id, None)
        if chat is None:
            chat = self._session_factory()
            while len(self._sessions) >= self.max_sessions:
                it = iter(self._sessions)
                evicted = next(it)
                if evicted == "":  # never evict the default session
                    evicted = next(it, None)
                    if evicted is None:
                        break
                self._sessions.pop(evicted)
        self._sessions[session_id] = chat  # (re)inserted at the LRU tail
        return chat

    def _stats(self) -> dict:
        """The counters of every live session (worker thread only)."""
        sessions = {sid: dict(c._session.stats) for sid, c in self._sessions.items()
                    if getattr(c, "_session", None) is not None}
        return {"mode": "session", "sessions": sessions}

    def _engine_request(self, payload):
        """The engine's (input_ids, pixel_values, gen) of a stateless request:
        a first turn of the default Chat's template."""
        from teochat_torch.config import GenerationConfig
        from teochat_torch.serve.chat import build_request

        chat = self.chat
        images = _decode_images(payload.get("images", []))
        input_ids, pixel_values, stop_str, _ = build_request(
            payload["prompt"], images, chat.tokenizer, chat.processor,
            conv_mode=chat.conv_mode, timestamps=payload.get("timestamps", []),
            bbox=payload.get("bbox"),
            mm_use_im_start_end=getattr(getattr(chat.model, "cfg", None),
                                        "mm_use_im_start_end", False),
        )
        temperature = float(payload.get("temperature", 0.2))
        gen = GenerationConfig(
            max_new_tokens=int(payload.get("max_new_tokens", 256)),
            temperature=temperature,
            do_sample=temperature > 0,
            stop_strings=(stop_str,),
        )
        return input_ids, pixel_values, gen

    def _response_text(self, tokens) -> str:
        return self.chat.tokenizer.decode(tokens).replace("</s>", "").strip()

    def _engine_generate(self, payload):
        """A stateless request through the continuous-batching engine, on the
        HTTP handler's thread (concurrency is the concurrent requests)."""
        from teochat_torch.eval.inference import extract_bboxes

        input_ids, pixel_values, gen = self._engine_request(payload)
        toks = self.engine.submit(input_ids, pixel_values, gen,
                                  adapter=int(payload.get("adapter", -1)))
        response = self._response_text(toks)
        return {"response": response, "bboxes": extract_bboxes(response)}

    def _worker(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            payload, done = job
            # in engine mode the session's device work waits for the
            # engine's scheduling iteration, and the engine for the turn
            lock = self.engine.device_lock if self.engine is not None else _NO_LOCK
            try:
                with lock:
                    self._job(payload, done)
            except Exception as e:  # noqa: BLE001 — the request's HTTP 400
                done["error"] = f"{type(e).__name__}: {e}"
            finally:
                done["event"].set()

    def _job(self, payload, done):
        """One job of the worker thread: /stats, /reset or a session turn."""
        if payload.get("_stats"):
            done["result"] = self._stats()
            return
        sid = str(payload.get("session_id") or "")
        if payload.get("_reset"):
            # an unknown or evicted session: nothing to reset, and no
            # session is made (or evicted) for it
            existing = self._sessions.get(sid)
            if existing is not None:
                existing.reset()
            done["result"] = {"status": "reset"}
            return
        chat = self._session_for(sid)
        images = _decode_images(payload.get("images", []))
        done["result"] = chat.generate(
            payload["prompt"],
            images,
            timestamps=payload.get("timestamps", []),
            bbox=payload.get("bbox"),
            temperature=float(payload.get("temperature", 0.2)),
            max_new_tokens=int(payload.get("max_new_tokens", 256)),
            speculative_k=int(payload.get("speculative_k", 0)),
        )

    def _run(self, payload) -> dict:
        """Hand a job to the worker thread and wait for its answer."""
        done = {"event": threading.Event()}
        self._jobs.put((payload, done))
        done["event"].wait()
        return done

    def make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_sse(self, payload):
                """Server-sent events: one `data:` event a decode chunk with
                the fresh token ids and the whole text so far, then
                `data: [DONE]` (engine mode only: its chunks yield tokens
                as they come)."""
                try:
                    input_ids, pixel_values, gen = server._engine_request(payload)
                except Exception as e:  # noqa: BLE001 — HTTP 400
                    return self._send(400, {"error": f"{type(e).__name__}: {e}"})
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                tokens = []
                try:
                    for fresh in server.engine.submit_stream(
                            input_ids, pixel_values, gen,
                            adapter=int(payload.get("adapter", -1))):
                        tokens.extend(fresh)
                        event = {"token_ids": fresh, "text": server._response_text(tokens)}
                        self.wfile.write(f"data: {json.dumps(event)}\n\n".encode())
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client went away; the engine still drains the request
                except (RuntimeError, ValueError) as e:
                    self.wfile.write(f"data: {json.dumps({'error': str(e)})}\n\n".encode())

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok"})
                elif self.path == "/stats":
                    if server.engine is not None:
                        stats = {**server.engine.stats, "mode": "continuous_batching"}
                        if stats.get("spec_iterations"):
                            stats["spec_mean_tokens_per_step"] = round(
                                stats["spec_tokens"] / stats["spec_iterations"], 3)
                        self._send(200, stats)
                    else:
                        self._send(200, server._run({"_stats": True})["result"])
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/generate", "/reset"):
                    return self._send(404, {"error": "not found"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(payload, dict):
                        return self._send(400, {"error": "bad request: not a JSON object"})
                    if self.path == "/generate" and "prompt" not in payload:
                        return self._send(400, {"error": "missing 'prompt'"})
                except (ValueError, json.JSONDecodeError) as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                if self.path == "/reset":
                    payload["_reset"] = True
                # a session_id (any string, "" the default session) or a reset
                # is stateful, in either mode; the engine takes the rest
                stateful = payload.get("session_id") is not None or payload.get("_reset")
                if payload.get("stream"):
                    if stateful:
                        return self._send(400, {
                            "error": "streaming requires a stateless request "
                                     "(engine mode, no session_id)"})
                    if server.engine is None:
                        return self._send(400, {
                            "error": "streaming needs the continuous-batching engine "
                                     "(--continuous_batching)"})
                    return self._send_sse(payload)
                if server.engine is not None and not stateful:
                    try:
                        return self._send(200, server._engine_generate(payload))
                    except Exception as e:  # noqa: BLE001 — HTTP 400
                        return self._send(400, {"error": f"{type(e).__name__}: {e}"})
                done = server._run(payload)
                if "error" in done:
                    return self._send(400, {"error": done["error"]})
                return self._send(200, done["result"])

        return Handler

    def serve_forever(self):
        self._worker_thread = threading.Thread(target=self._worker, daemon=True)
        self._worker_thread.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        self._httpd.serve_forever()

    def start_background(self):
        """Serve from a background thread; returns once the socket is bound
        (`_httpd.server_address` then holds the port)."""
        self._serve_thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._serve_thread.start()
        deadline = time.monotonic() + 10.0
        while self._httpd is None:
            if time.monotonic() > deadline or not self._serve_thread.is_alive():
                raise RuntimeError("ChatServer: the server did not start")
            time.sleep(0.01)
        return self

    def shutdown(self):
        """Stop serving, let the worker finish its job, and join both threads."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._jobs.put(None)
        for t in (self._serve_thread, self._worker_thread):
            if t is not None:
                t.join(60.0)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="TEOChat JSON serving endpoint (PyTorch, one CUDA card)")
    p.add_argument("--model_path", required=True)
    p.add_argument("--vision_path", default=None)
    p.add_argument("--load_8bit", action="store_true", default=True)
    p.add_argument("--quantize_vision", action="store_true",
                   help="w8a8 int8 vision tower (per-token int8 activations on the int8 "
                        "tensor cores; close to, not equal to, bf16)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--continuous_batching", action="store_true",
                   help="multiplex concurrent requests over per-request KV rows of one cache")
    p.add_argument("--max_slots", type=int, default=4)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--chunk", type=int, default=8,
                   help="decode steps between host scheduling points (engine mode only): "
                        "small chunks shorten admission waits, large ones read tokens less "
                        "often")
    p.add_argument("--prefill_chunk", type=int, default=None,
                   help="chunked prefill: commit a long prompt's K/V in pieces of this many "
                        "fused tokens, one piece a decode chunk, bounding the stall of running "
                        "streams (engine mode only; default monolithic)")
    p.add_argument("--prefix_cache_slots", type=int, default=0,
                   help="automatic prefix caching: pool this many extra KV rows; requests "
                        "sharing a leading text run seed their KV from the pool and prefill "
                        "only the suffix (engine mode only; 0 = off)")
    p.add_argument("--prefix_min_tokens", type=int, default=256,
                   help="only pool text prefixes of at least this many tokens")
    p.add_argument("--speculative_k", type=int, default=0,
                   help="verify k prompt-lookup drafts a decode step (engine mode only; greedy "
                        "rows give the plain tokens, sampled rows draw by exact speculative "
                        "sampling: the same distribution, not the same draws)")
    p.add_argument("--lora_paths", default=None,
                   help="comma-separated peft adapter dirs for multi-LoRA serving: adapters stay "
                        "UNMERGED over the shared (quantized) backbone and each request picks "
                        "one by the JSON 'adapter' field (an index into this list; -1 or absent: "
                        "the base model)")
    args = p.parse_args(argv)

    from teochat_torch.serve.chat import Chat
    from teochat_torch.utils import resolve_device

    device = resolve_device(None)  # the card; raises without one
    chat = Chat(args.model_path, load_8bit=args.load_8bit, vision_path=args.vision_path,
                quantize_vision=args.quantize_vision, device=device)
    if args.lora_paths:
        from teochat_torch.builder import load_multi_lora

        chat.model = load_multi_lora(chat.model, [d for d in args.lora_paths.split(",") if d])
        if chat._session is not None:
            # a session turn passes no route: over the stacked params it
            # raises, where the old model would answer as the base one
            chat._session.model = chat.model
    engine = None
    if args.continuous_batching:
        from teochat_torch.serve.engine import BatchEngine

        engine = BatchEngine(
            chat.model, max_slots=args.max_slots, max_len=args.max_len, chunk=args.chunk,
            speculative_k=args.speculative_k, prefill_chunk=args.prefill_chunk, prefix_cache_slots=args.prefix_cache_slots,
            prefix_min_tokens=args.prefix_min_tokens,
        ).start()
    print(f"serving on {args.host}:{args.port}" + (" (continuous batching)" if engine else ""))
    ChatServer(chat, args.host, args.port, engine=engine).serve_forever()


if __name__ == "__main__":
    main()

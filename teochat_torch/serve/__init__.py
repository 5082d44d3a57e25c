"""Serving: the chat server and its incremental KV sessions (port of teochat_tpu/serve).

`session.ChatSession` keeps one KV cache a conversation and prefills only
each turn's suffix; `chat.Chat` is the stateful chat over it; `server`
serves Chat sessions as JSON over HTTP from one worker thread; `demo` is
the Gradio shell (gradio imported only when the demo is built); `maptiles`
the map-tile math behind the demo's map panel.
"""

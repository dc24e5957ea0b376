"""Serving steps: prefill (prompt -> cache) and serve_step (one new token
against a standing cache)."""
from __future__ import annotations


def make_prefill_step(model, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, tokens):
        """tokens: (B,1) int32 -> (cache updated in place, logits (B,1,V))."""
        return model.decode_step(params, cache, tokens)
    return serve_step

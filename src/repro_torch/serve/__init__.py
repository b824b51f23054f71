"""Serving: prefill/decode steps and the continuous batcher."""

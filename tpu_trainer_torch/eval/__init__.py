"""Evaluation entry points: ``infer`` (checkpoint -> generated text)."""

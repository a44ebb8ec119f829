"""Shared helpers (int8 KV quantization, device resolution)."""

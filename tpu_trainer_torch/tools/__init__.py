"""Offline tooling over training artifacts (JSONL runs, crash reports)."""

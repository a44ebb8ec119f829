"""Model configuration, the GPT (paged-decode mode) and weight loading."""

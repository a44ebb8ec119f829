"""Training: configuration, optimizer and the single-device trainer."""

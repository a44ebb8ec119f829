"""Host-side data feeds of the port."""

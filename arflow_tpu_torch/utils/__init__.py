"""Host-side helpers of the trainer (the port's own copies)."""

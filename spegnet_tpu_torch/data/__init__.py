"""Host-side input pipeline."""

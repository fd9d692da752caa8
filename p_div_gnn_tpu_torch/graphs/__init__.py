"""Host-side (numpy) mesh → graph → padded batch pipeline."""

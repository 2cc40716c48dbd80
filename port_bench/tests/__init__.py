"""The harness's own tests (CPU; those marked `cuda` need the card)."""

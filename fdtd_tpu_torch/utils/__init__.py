"""Host-side analysis helpers (numpy only)."""

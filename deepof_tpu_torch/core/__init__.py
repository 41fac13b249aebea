"""Static skeleton topology (numpy only)."""

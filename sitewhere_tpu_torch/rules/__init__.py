"""Rule-program compiler (CEP-lite specs -> program tables)."""

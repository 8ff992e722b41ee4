"""Actuation-policy compiler (alert->command policies -> tables)."""

"""Data helpers of the port (only what the sampling slice needs)."""

"""Scene description, building and device-side queries."""

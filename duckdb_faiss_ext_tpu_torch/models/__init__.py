"""Index models: Flat and the IDMap wrapper."""

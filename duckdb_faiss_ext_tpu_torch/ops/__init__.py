"""Search operators: distance tiles, the plain scan, the Flat kernel,
selectors and bitmaps."""

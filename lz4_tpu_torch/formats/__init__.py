"""LZ4 Frame constants and header bytes (writer side)."""

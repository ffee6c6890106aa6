"""The roundtrip step and packed frames on one device."""

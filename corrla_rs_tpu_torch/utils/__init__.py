"""Configuration, device, random-generator, debug and conversion helpers."""

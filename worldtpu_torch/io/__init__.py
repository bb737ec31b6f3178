"""WAV and parameter-file I/O (numpy only)."""

"""Audio decoding: ctypes bindings over the repository's native WAV/FLAC readers."""

"""Configuration and checkpoint naming (pure Python)."""

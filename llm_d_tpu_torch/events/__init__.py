"""KV-cache events for the EPP's precise prefix index."""

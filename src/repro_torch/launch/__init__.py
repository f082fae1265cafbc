"""Entry points of the LLM side: ``serve`` (the decode Engine)."""

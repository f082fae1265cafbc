"""Entry points of the LLM side: ``serve`` (the decode Engine) and
``train`` (the fault-tolerant trainer)."""

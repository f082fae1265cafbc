"""Entry points of the LLM side: ``serve`` (the decode Engine) and
``train`` (the fault-tolerant trainer), and ``mesh`` (the device meshes
the sharding rules and the serving mesh run on)."""

"""Serving for the port.

Only the LM demo is ported so far: import it explicitly
(``from repro_torch.serving import llm_demo``). The graph query server of
the JAX package's ``repro.serving`` (API, session pool, micro-batching
server) is ROADMAP A11.
"""

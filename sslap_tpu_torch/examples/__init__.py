"""Runnable examples of the port, counterparts of ``examples/``: ``python
-m sslap_tpu_torch.examples.basic``, ``.tracking`` and ``.distributed``,
each with ``--device cuda|cpu`` (the card by default).  Each ``main()``
returns what it prints."""

"""Reference optimizers, one module an optimizer name (the traffic's
``optimizer``), each with ``CAPTURE``, ``init`` and ``step``."""

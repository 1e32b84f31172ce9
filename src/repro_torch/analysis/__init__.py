"""Counting one rank's step: FLOPs, device-memory bytes and collectives
(``counter``), and the hooks the model code gives it (``scopes``)."""

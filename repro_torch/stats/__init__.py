"""Statistical substrate: synthetic generators (twin of ``repro.stats``)."""

"""Launch helpers: the device mesh and the processes behind it (twin of ``repro.launch``)."""

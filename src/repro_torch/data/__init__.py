"""Input pipelines (the port of ``repro.data``)."""

"""The reference's pipelines, one module each, found by the ``pipeline`` a
configuration names (`port_bench.catalog`)."""

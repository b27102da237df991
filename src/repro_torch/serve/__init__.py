"""Serving: ``engine``, the LM half (prefill and serve steps, ``ServeLoop``)."""

"""Command-line entry points of the port (``python -m
autostyle_tts_tpu_torch.cli.<name>``): the retrieval workflow
``insert_embeddings`` -> ``search_json`` -> ``tts_with_rag``, and the two
other query entry points ``search`` and ``search_embeddings``. Each runs on
the card unless ``--device cpu``."""

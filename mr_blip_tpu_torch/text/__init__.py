"""Host-side text utilities. The span grammar, timestamps and the mock
tokenizer are copied from ``mr_blip_tpu.text`` (they import only ``re``,
``ast`` and ``numpy``, so the port carries its own copy rather than
importing the JAX package); the reader of HF tokenizer directories
(``tokenizer_json``, ``bpe``, ``precompiled_charsmap``) and ``vocab_facts``
are the port's own, where the JAX package leans on ``transformers``."""

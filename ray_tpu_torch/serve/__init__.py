"""Serving on PyTorch: the continuous-batching LLM engine (``llm.py``)."""

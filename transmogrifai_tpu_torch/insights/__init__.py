"""Model insights: the post-train report (``model_insights.py``) and the
record insights, LOCO and correlation-based (``loco.py``)."""

"""Model insights: the post-train report (``model_insights.py``).  LOCO
record insights (``loco.py``) come with the other reports (ROADMAP.md
queue 1, item 8)."""

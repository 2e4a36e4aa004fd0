"""Data substrate: QUEST synthetic generator and Table-1 stand-ins."""

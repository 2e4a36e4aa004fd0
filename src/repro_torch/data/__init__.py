"""Data substrate: QUEST synthetic generator, Table-1 stand-ins and the
sharded LM token loader."""

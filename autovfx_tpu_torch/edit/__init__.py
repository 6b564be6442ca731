"""The edit layer: the edit IR, events, mesh IO, the DSL and the scene."""

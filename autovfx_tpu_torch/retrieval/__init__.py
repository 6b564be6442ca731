"""Asset and material retrieval: the local index, library and previews."""

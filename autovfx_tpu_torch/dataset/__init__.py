"""Dataset ingestion: COLMAP models."""

"""The supervised training dataset and its collator."""

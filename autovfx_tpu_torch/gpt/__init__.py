"""The language-model program runner and its prompts."""

"""Core sketch structures, estimators and builders."""

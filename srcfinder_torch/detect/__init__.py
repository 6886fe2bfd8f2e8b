"""Plume detection: FCN saliency and the salience-to-plume-list step."""

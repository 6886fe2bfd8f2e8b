"""Plume detection: FCN saliency, dense CNN saliency and the
salience-to-plume-list step."""

"""BSDF evaluation and sampling over material-tagged wavefronts."""

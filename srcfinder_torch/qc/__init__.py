"""Plume QC: the label taxonomy, candidate ids and coordinate helpers
(reference: cmftagger/util.py). The port's ``qc`` holds ``labels`` only;
the JAX package's labelling sessions, consensus merge and web app are
still to be ported."""

from .labels import (CMFCOL, EVALCOL, LIDCOL, CIDCOL, LATCOL, LONCOL, LABCOL,
                     CLSCOL, UIDCOL, DONECOL, ROWCOL, COLCOL, XCOL, YCOL,
                     KEEPLAB, REJLAB, PLUMELAB, SUPERLAB, POSLABS, ARTFLAB,
                     CLOUDLAB, FALSELAB, NEGLABS, AMBLAB, BGLAB, DUPLAB,
                     AMBLABS, classlabs, next_cid, lnglat_to_meters,
                     meters_to_lnglat, cmff_to_lid, lid2uidassign,
                     save_flag_csv, load_flag_csv, save_classlabs)

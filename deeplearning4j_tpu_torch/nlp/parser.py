"""PCFG-CKY constituency parser
(the port's copy of ``deeplearning4j_tpu/nlp/parser.py``).

≙ the reference's TreeParser (text/corpora/treeparser/TreeParser.java),
which turns raw text into constituency trees through UIMA/OpenNLP
models, feeding RNTN and the recursive autoencoder. No pretrained
OpenNLP models exist offline, so this module replaces round 1's
right-branching fallback with a real parser: a probabilistic CFG
extracted from a bundled PTB-style mini-treebank, decoded with CKY
(exact Viterbi parse over the binarized grammar).

Pipeline parity:
- grammar extraction runs the same binarize + collapse-unaries
  transforms the reference applies to parser output
  (BinarizeTreeTransformer.java:133, CollapseUnaries), so CKY's
  derivations live in exactly the tree space downstream models consume;
- unknown words back off to an open-class tag distribution estimated
  from singleton counts (standard PCFG practice), so novel sentences
  still parse;
- sentences the grammar cannot span fall back to the round-1
  right-branching tree — the consumer contract (every sentence yields a
  binary tree) is unchanged.

The bundled treebank is a hand-built, self-consistent sample in
Penn-treebank bracketed style: enough NP/VP/PP/SBAR structure that
parsed trees are measurably non-right-branching (subject NPs with PP
attachment produce left-heavy splits no right-branching fallback can).
"""

from __future__ import annotations

import functools
import math
from collections import Counter, defaultdict

from deeplearning4j_tpu_torch.nlp.tree import (
    Tree,
    binarize,
    collapse_unaries,
    parse_ptb,
    right_branching_tree,
)

# -- bundled treebank ---------------------------------------------------------
# Hand-written PTB-style sample trees (the role the reference's OpenNLP
# model files play; ≙ TreeParser.java model coverage). Grown ~10x in
# round 5 (VERDICT r4 #7): beyond the original DT/JJ/NN NPs, PP
# attachment and (di)transitives, it now covers copulas with ADJP/NP/PP
# predicates, modals and negation, adverbs, progressives and passives,
# infinitival and gerund complements, SBAR complement clauses,
# relative clauses (object and subject gap, WDT/WP), NP/VP/S/JJ
# coordination, possessives, plurals, numerals and existential-there —
# so CKY parses of ordinary declarative English resolve through real
# productions instead of the right-branching fallback.
_TREEBANK = """
(S (NP (DT the) (NN cat)) (VP (VBD saw) (NP (DT a) (NN dog))))
(S (NP (DT the) (NN dog)) (VP (VBD chased) (NP (DT the) (NN cat))))
(S (NP (DT a) (NN man)) (VP (VBD read) (NP (DT a) (NN book))))
(S (NP (DT the) (NN woman)) (VP (VBD liked) (NP (DT the) (NN park))))
(S (NP (DT the) (NN child)) (VP (VBD found) (NP (DT a) (NN ball))))
(S (NP (DT a) (NN bird)) (VP (VBD watched) (NP (DT the) (NN fish))))
(S (NP (NP (DT the) (NN cat)) (PP (IN on) (NP (DT the) (NN mat)))) (VP (VBD saw) (NP (DT a) (NN dog))))
(S (NP (NP (DT the) (NN man)) (PP (IN in) (NP (DT the) (NN park)))) (VP (VBD read) (NP (DT a) (NN book))))
(S (NP (NP (DT a) (NN dog)) (PP (IN near) (NP (DT the) (NN tree)))) (VP (VBD chased) (NP (DT the) (NN bird))))
(S (NP (NP (DT the) (NN woman)) (PP (IN with) (NP (DT the) (NN ball)))) (VP (VBD watched) (NP (DT the) (NN child))))
(S (NP (DT the) (NN cat)) (VP (VBD sat) (PP (IN on) (NP (DT the) (NN mat)))))
(S (NP (DT the) (NN dog)) (VP (VBD slept) (PP (IN under) (NP (DT the) (NN tree)))))
(S (NP (DT the) (NN man)) (VP (VBD walked) (PP (IN in) (NP (DT the) (NN park)))))
(S (NP (DT the) (NN child)) (VP (VBD played) (PP (IN with) (NP (DT a) (NN ball)))))
(S (NP (DT the) (NN woman)) (VP (VBD gave) (NP (DT the) (NN dog)) (NP (DT a) (NN fish))))
(S (NP (DT the) (NN man)) (VP (VBD gave) (NP (DT the) (NN child)) (NP (DT a) (NN book))))
(S (NP (DT the) (JJ big) (NN dog)) (VP (VBD chased) (NP (DT the) (JJ small) (NN cat))))
(S (NP (DT a) (JJ happy) (NN child)) (VP (VBD found) (NP (DT the) (JJ red) (NN ball))))
(S (NP (DT the) (JJ old) (NN man)) (VP (VBD read) (NP (DT the) (JJ old) (NN book))))
(S (NP (PRP he)) (VP (VBD saw) (NP (DT the) (NN cat))))
(S (NP (PRP she)) (VP (VBD liked) (NP (DT the) (NN dog))))
(S (NP (PRP they)) (VP (VBD watched) (NP (DT the) (NN bird))))
(S (NP (PRP he)) (VP (VBD walked) (PP (IN near) (NP (DT the) (NN house)))))
(S (NP (NNP mary)) (VP (VBD saw) (NP (NNP john))))
(S (NP (NNP john)) (VP (VBD liked) (NP (NNP mary))))
(S (NP (NNP mary)) (VP (VBD gave) (NP (NNP john)) (NP (DT a) (NN book))))
(S (NP (DT the) (NN cat)) (VP (VBD saw) (NP (NP (DT a) (NN dog)) (PP (IN in) (NP (DT the) (NN park))))))
(S (NP (DT the) (NN bird)) (VP (VBD found) (NP (NP (DT a) (NN fish)) (PP (IN near) (NP (DT the) (NN house))))))
(S (NP (DT the) (JJ small) (NN bird)) (VP (VBD sat) (PP (IN on) (NP (DT the) (JJ big) (NN tree)))))
(S (NP (NP (DT the) (NN cat)) (PP (IN under) (NP (DT the) (NN house)))) (VP (VBD watched) (NP (DT the) (NN fish))))
(S (NP (DT the) (NN boy)) (VP (VBD ate) (NP (DT an) (NN apple))))
(S (NP (DT the) (NN girl)) (VP (VBD wrote) (NP (DT a) (NN letter))))
(S (NP (DT the) (NN teacher)) (VP (VBD helped) (NP (DT the) (NN student))))
(S (NP (DT the) (NN farmer)) (VP (VBD fed) (NP (DT the) (NN horse))))
(S (NP (DT the) (NN doctor)) (VP (VBD visited) (NP (DT the) (NN city))))
(S (NP (DT the) (NN boy)) (VP (VBD kicked) (NP (DT the) (NN ball))))
(S (NP (DT the) (NN girl)) (VP (VBD caught) (NP (DT the) (NN fish))))
(S (NP (DT the) (NN man)) (VP (VBD built) (NP (DT a) (NN house))))
(S (NP (DT the) (NN woman)) (VP (VBD opened) (NP (DT the) (NN door))))
(S (NP (DT the) (NN child)) (VP (VBD closed) (NP (DT the) (NN window))))
(S (NP (DT the) (NN student)) (VP (VBD heard) (NP (DT a) (NN song))))
(S (NP (DT the) (NN friend)) (VP (VBD followed) (NP (DT the) (NN road))))
(S (NP (DT the) (NN cat)) (VP (VBZ sees) (NP (DT a) (NN bird))))
(S (NP (DT the) (NN dog)) (VP (VBZ chases) (NP (DT the) (NN cat))))
(S (NP (DT the) (NN man)) (VP (VBZ reads) (NP (DT a) (NN book))))
(S (NP (DT the) (NN woman)) (VP (VBZ likes) (NP (DT the) (NN garden))))
(S (NP (DT the) (NN child)) (VP (VBZ finds) (NP (DT a) (NN ball))))
(S (NP (DT the) (NN bird)) (VP (VBZ watches) (NP (DT the) (NN river))))
(S (NP (DT the) (NN boy)) (VP (VBZ eats) (NP (DT an) (NN apple))))
(S (NP (DT the) (NN teacher)) (VP (VBZ helps) (NP (DT the) (NN student))))
(S (NP (DT the) (NN girl)) (VP (VBZ loves) (NP (DT the) (NN song))))
(S (NP (DT the) (NNS dogs)) (VP (VBP chase) (NP (DT the) (NNS cats))))
(S (NP (DT the) (NNS cats)) (VP (VBP see) (NP (DT the) (NNS birds))))
(S (NP (DT the) (NNS children)) (VP (VBP like) (NP (DT the) (NN park))))
(S (NP (DT the) (NNS students)) (VP (VBP read) (NP (DT the) (NNS books))))
(S (NP (DT the) (NNS men)) (VP (VBP watch) (NP (DT the) (NNS horses))))
(S (NP (NNS dogs)) (VP (VBP chase) (NP (NNS cats))))
(S (NP (NNS birds)) (VP (VBP like) (NP (NNS trees))))
(S (NP (NNS children)) (VP (VBP love) (NP (NNS songs))))
(S (NP (DT the) (NN horse)) (VP (VBD ran)))
(S (NP (DT the) (NN child)) (VP (VBD slept)))
(S (NP (DT the) (NN bird)) (VP (VBD sang)))
(S (NP (DT the) (NNS dogs)) (VP (VBP sleep)))
(S (NP (DT the) (NN cat)) (VP (VBZ sleeps)))
(S (NP (DT the) (NN boy)) (VP (VBD ran) (PP (IN to) (NP (DT the) (NN school)))))
(S (NP (DT the) (NN girl)) (VP (VBD walked) (PP (IN to) (NP (DT the) (NN garden)))))
(S (NP (DT the) (NN farmer)) (VP (VBD worked) (PP (IN at) (NP (DT the) (NN farm)))))
(S (NP (DT the) (NN teacher)) (VP (VBD sat) (PP (IN by) (NP (DT the) (NN window)))))
(S (NP (DT the) (NN doctor)) (VP (VBD slept) (PP (IN in) (NP (DT the) (NN house)))))
(S (NP (DT the) (NN student)) (VP (VBD played) (PP (IN after) (NP (DT the) (NN school)))))
(S (NP (DT the) (NN man)) (VP (VBD left) (PP (IN before) (NP (DT the) (NN storm)))))
(S (NP (DT the) (NN dog)) (VP (VBD hid) (PP (IN behind) (NP (DT the) (NN door)))))
(S (NP (DT the) (NN cat)) (VP (VBD jumped) (PP (IN over) (NP (DT the) (NN fence)))))
(S (NP (DT the) (NN bird)) (VP (VBD flew) (PP (IN over) (NP (DT the) (NN river)))))
(S (NP (DT the) (NN woman)) (VP (VBD gave) (NP (DT the) (NN book)) (PP (TO to) (NP (DT the) (NN student)))))
(S (NP (DT the) (NN man)) (VP (VBD gave) (NP (DT the) (NN ball)) (PP (TO to) (NP (DT the) (NN child)))))
(S (NP (DT the) (NN teacher)) (VP (VBD showed) (NP (DT the) (NN letter)) (PP (TO to) (NP (DT the) (NN doctor)))))
(S (NP (DT the) (NN boy)) (VP (VBD sent) (NP (DT a) (NN letter)) (PP (TO to) (NP (DT the) (NN girl)))))
(S (NP (DT the) (NN farmer)) (VP (VBD sold) (NP (DT the) (NN horse)) (PP (TO to) (NP (DT the) (NN man)))))
(S (NP (NNP mary)) (VP (VBD told) (NP (NNP john)) (NP (DT a) (NN story))))
(S (NP (DT the) (NN teacher)) (VP (VBD told) (NP (DT the) (NNS children)) (NP (DT a) (NN story))))
(S (NP (DT the) (NN man)) (VP (VBD showed) (NP (DT the) (NN child)) (NP (DT the) (NN garden))))
(S (NP (DT the) (JJ young) (NN doctor)) (VP (VBD helped) (NP (DT the) (JJ old) (NN farmer))))
(S (NP (DT the) (JJ tall) (NN boy)) (VP (VBD kicked) (NP (DT the) (JJ blue) (NN ball))))
(S (NP (DT a) (JJ quiet) (NN girl)) (VP (VBD read) (NP (DT a) (JJ long) (NN book))))
(S (NP (DT the) (JJ hungry) (NN dog)) (VP (VBD ate) (NP (DT the) (JJ small) (NN fish))))
(S (NP (DT the) (JJ tired) (NN man)) (VP (VBD slept) (PP (IN under) (NP (DT the) (JJ green) (NN tree)))))
(S (NP (DT the) (JJ kind) (NN woman)) (VP (VBD helped) (NP (DT the) (JJ young) (NN student))))
(S (NP (DT the) (JJ big) (JJ red) (NN ball)) (VP (VBD rolled) (PP (IN down) (NP (DT the) (NN road)))))
(S (NP (DT a) (JJ small) (JJ white) (NN bird)) (VP (VBD sang) (PP (IN in) (NP (DT the) (NN garden)))))
(S (NP (PRP i)) (VP (VBD saw) (NP (DT a) (NN bird))))
(S (NP (PRP we)) (VP (VBD walked) (PP (IN in) (NP (DT the) (NN city)))))
(S (NP (PRP you)) (VP (VBP like) (NP (DT the) (NN song))))
(S (NP (PRP it)) (VP (VBD slept) (PP (IN on) (NP (DT the) (NN mat)))))
(S (NP (PRP she)) (VP (VBZ reads) (NP (NNS books))))
(S (NP (PRP he)) (VP (VBZ likes) (NP (DT the) (NN garden))))
(S (NP (PRP they)) (VP (VBP play) (PP (IN in) (NP (DT the) (NN park)))))
(S (NP (PRP we)) (VP (VBP love) (NP (DT the) (NN city))))
(S (NP (PRP$ his) (NN dog)) (VP (VBD chased) (NP (DT the) (NN cat))))
(S (NP (PRP$ her) (NN book)) (VP (VBD fell) (PP (IN on) (NP (DT the) (NN floor)))))
(S (NP (DT the) (NN boy)) (VP (VBD found) (NP (PRP$ his) (NN ball))))
(S (NP (DT the) (NN girl)) (VP (VBD liked) (NP (PRP$ her) (NN teacher))))
(S (NP (PRP$ their) (NN house)) (VP (VBZ is) (ADJP (JJ big))))
(S (NP (PRP$ my) (NN friend)) (VP (VBD visited) (NP (DT the) (NN city))))
(S (NP (PRP$ our) (NN teacher)) (VP (VBD told) (NP (DT a) (NN story))))
(S (NP (PRP he)) (VP (VBD lost) (NP (PRP$ his) (NN letter))))
(S (NP (CD two) (NNS dogs)) (VP (VBD chased) (NP (DT the) (NN cat))))
(S (NP (CD three) (NNS birds)) (VP (VBD sat) (PP (IN on) (NP (DT the) (NN tree)))))
(S (NP (DT the) (CD two) (NNS children)) (VP (VBD played) (PP (IN in) (NP (DT the) (NN park)))))
(S (NP (CD four) (NNS students)) (VP (VBD read) (NP (CD two) (NNS books))))
(S (NP (DT the) (NN cat)) (VP (VBZ is) (ADJP (JJ happy))))
(S (NP (DT the) (NN dog)) (VP (VBZ is) (ADJP (JJ hungry))))
(S (NP (DT the) (NN house)) (VP (VBZ is) (ADJP (JJ old))))
(S (NP (DT the) (NNS birds)) (VP (VBP are) (ADJP (JJ small))))
(S (NP (DT the) (NNS children)) (VP (VBP are) (ADJP (JJ tired))))
(S (NP (DT the) (NN man)) (VP (VBD was) (ADJP (JJ tall))))
(S (NP (DT the) (NN woman)) (VP (VBD was) (ADJP (JJ kind))))
(S (NP (DT the) (NNS students)) (VP (VBD were) (ADJP (JJ quiet))))
(S (NP (DT the) (NN man)) (VP (VBZ is) (NP (DT a) (NN doctor))))
(S (NP (DT the) (NN woman)) (VP (VBZ is) (NP (DT a) (NN teacher))))
(S (NP (NNP john)) (VP (VBZ is) (NP (DT a) (NN farmer))))
(S (NP (PRP he)) (VP (VBD was) (NP (DT a) (NN student))))
(S (NP (PRP she)) (VP (VBZ is) (NP (PRP$ my) (NN friend))))
(S (NP (DT the) (NN cat)) (VP (VBZ is) (PP (IN on) (NP (DT the) (NN mat)))))
(S (NP (DT the) (NN dog)) (VP (VBZ is) (PP (IN in) (NP (DT the) (NN garden)))))
(S (NP (DT the) (NN book)) (VP (VBD was) (PP (IN on) (NP (DT the) (NN table)))))
(S (NP (DT the) (NNS birds)) (VP (VBP are) (PP (IN in) (NP (DT the) (NN tree)))))
(S (NP (DT the) (NN ball)) (VP (VBD was) (PP (IN under) (NP (DT the) (NN table)))))
(S (NP (EX there)) (VP (VBZ is) (NP (DT a) (NN dog)) (PP (IN in) (NP (DT the) (NN garden)))))
(S (NP (EX there)) (VP (VBP are) (NP (CD two) (NNS cats)) (PP (IN on) (NP (DT the) (NN mat)))))
(S (NP (EX there)) (VP (VBD was) (NP (DT a) (NN book)) (PP (IN on) (NP (DT the) (NN table)))))
(S (NP (EX there)) (VP (VBZ is) (NP (DT a) (NN bird)) (PP (IN near) (NP (DT the) (NN window)))))
(S (NP (DT the) (NN dog)) (VP (MD can) (VP (VB run))))
(S (NP (DT the) (NN bird)) (VP (MD can) (VP (VB sing))))
(S (NP (DT the) (NN child)) (VP (MD can) (VP (VB read) (NP (DT a) (NN book)))))
(S (NP (DT the) (NN man)) (VP (MD will) (VP (VB help) (NP (DT the) (NN woman)))))
(S (NP (DT the) (NN teacher)) (VP (MD will) (VP (VB tell) (NP (DT a) (NN story)))))
(S (NP (DT the) (NN boy)) (VP (MD must) (VP (VB go) (PP (TO to) (NP (DT the) (NN school))))))
(S (NP (PRP they)) (VP (MD should) (VP (VB walk) (PP (IN in) (NP (DT the) (NN park))))))
(S (NP (PRP she)) (VP (MD may) (VP (VB visit) (NP (DT the) (NN city)))))
(S (NP (DT the) (NN dog)) (VP (MD will) (RB not) (VP (VB sleep))))
(S (NP (DT the) (NN child)) (VP (MD can) (RB not) (VP (VB find) (NP (DT the) (NN ball)))))
(S (NP (PRP he)) (VP (MD must) (RB not) (VP (VB open) (NP (DT the) (NN door)))))
(S (NP (PRP they)) (VP (MD should) (RB not) (VP (VB play) (PP (IN near) (NP (DT the) (NN river))))))
(S (NP (DT the) (NN horse)) (VP (VBD ran) (ADVP (RB quickly))))
(S (NP (DT the) (NN cat)) (VP (VBD walked) (ADVP (RB slowly))))
(S (NP (DT the) (NN child)) (VP (VBD sang) (ADVP (RB happily))))
(S (NP (DT the) (NN dog)) (VP (ADVP (RB often)) (VP (VBZ sleeps) (PP (IN on) (NP (DT the) (NN mat))))))
(S (NP (PRP she)) (VP (ADVP (RB never)) (VP (VBD read) (NP (DT the) (NN letter)))))
(S (NP (DT the) (NNS birds)) (VP (VBD sang) (ADVP (RB here))))
(S (NP (PRP they)) (VP (VBD played) (ADVP (RB today))))
(S (NP (DT the) (NN man)) (VP (VBD spoke) (ADVP (RB quietly))))
(S (NP (DT the) (NN dog)) (VP (VBD was) (VP (VBG running) (PP (IN in) (NP (DT the) (NN park))))))
(S (NP (DT the) (NN child)) (VP (VBD was) (VP (VBG playing) (PP (IN with) (NP (DT the) (NN ball))))))
(S (NP (DT the) (NN bird)) (VP (VBZ is) (VP (VBG singing) (PP (IN in) (NP (DT the) (NN tree))))))
(S (NP (DT the) (NNS students)) (VP (VBP are) (VP (VBG reading) (NP (NNS books)))))
(S (NP (DT the) (NN woman)) (VP (VBD was) (VP (VBG writing) (NP (DT a) (NN letter)))))
(S (NP (DT the) (NN cat)) (VP (VBD was) (VP (VBN chased) (PP (IN by) (NP (DT the) (NN dog))))))
(S (NP (DT the) (NN ball)) (VP (VBD was) (VP (VBN found) (PP (IN by) (NP (DT the) (NN child))))))
(S (NP (DT the) (NN letter)) (VP (VBD was) (VP (VBN written) (PP (IN by) (NP (DT the) (NN girl))))))
(S (NP (DT the) (NN song)) (VP (VBD was) (VP (VBN heard) (PP (IN by) (NP (DT the) (NNS children))))))
(S (NP (DT the) (NN house)) (VP (VBD was) (VP (VBN built) (PP (IN by) (NP (DT the) (NN farmer))))))
(S (NP (DT the) (NN boy)) (VP (VBD wanted) (S (VP (TO to) (VP (VB play))))))
(S (NP (DT the) (NN girl)) (VP (VBD wanted) (S (VP (TO to) (VP (VB read) (NP (DT a) (NN book)))))))
(S (NP (DT the) (NN dog)) (VP (VBD tried) (S (VP (TO to) (VP (VB catch) (NP (DT the) (NN bird)))))))
(S (NP (PRP they)) (VP (VBD wanted) (S (VP (TO to) (VP (VB visit) (NP (DT the) (NN city)))))))
(S (NP (PRP she)) (VP (VBD tried) (S (VP (TO to) (VP (VB open) (NP (DT the) (NN door)))))))
(S (NP (DT the) (NN man)) (VP (VBD liked) (S (VP (TO to) (VP (VB walk) (PP (IN in) (NP (DT the) (NN park))))))))
(S (NP (DT the) (NN child)) (VP (VBZ likes) (VP (VBG playing) (PP (IN with) (NP (DT the) (NN dog))))))
(S (NP (DT the) (NN woman)) (VP (VBD enjoyed) (VP (VBG walking) (PP (IN near) (NP (DT the) (NN river))))))
(S (NP (DT the) (NN man)) (VP (VBD said) (SBAR (IN that) (S (NP (DT the) (NN dog)) (VP (VBD slept))))))
(S (NP (DT the) (NN woman)) (VP (VBD said) (SBAR (IN that) (S (NP (DT the) (NN cat)) (VP (VBD found) (NP (DT the) (NN fish)))))))
(S (NP (DT the) (NN teacher)) (VP (VBD said) (SBAR (IN that) (S (NP (DT the) (NNS students)) (VP (VBD read) (NP (DT the) (NNS books)))))))
(S (NP (PRP he)) (VP (VBD thought) (SBAR (IN that) (S (NP (DT the) (NN bird)) (VP (VBD sang))))))
(S (NP (PRP she)) (VP (VBD thought) (SBAR (IN that) (S (NP (DT the) (NN child)) (VP (VBD played) (PP (IN in) (NP (DT the) (NN park))))))))
(S (NP (NNP john)) (VP (VBD knew) (SBAR (IN that) (S (NP (NNP mary)) (VP (VBD liked) (NP (DT the) (NN garden)))))))
(S (NP (DT the) (NN boy)) (VP (VBD knew) (SBAR (IN that) (S (NP (DT the) (NN dog)) (VP (VBD hid) (PP (IN behind) (NP (DT the) (NN tree))))))))
(S (NP (DT the) (NN doctor)) (VP (VBD believed) (SBAR (IN that) (S (NP (DT the) (NN man)) (VP (VBD was) (ADJP (JJ tired)))))))
(S (NP (NP (DT the) (NN man)) (SBAR (WHNP (WDT that)) (S (VP (VBD saw) (NP (DT the) (NN dog)))))) (VP (VBD walked) (PP (IN in) (NP (DT the) (NN park)))))
(S (NP (NP (DT the) (NN dog)) (SBAR (WHNP (WDT that)) (S (VP (VBD chased) (NP (DT the) (NN cat)))))) (VP (VBD slept)))
(S (NP (NP (DT the) (NN book)) (SBAR (WHNP (WDT that)) (S (NP (DT the) (NN girl)) (VP (VBD read))))) (VP (VBD was) (ADJP (JJ old))))
(S (NP (NP (DT the) (NN ball)) (SBAR (WHNP (WDT that)) (S (NP (DT the) (NN child)) (VP (VBD found))))) (VP (VBD was) (ADJP (JJ red))))
(S (NP (NP (DT the) (NN woman)) (SBAR (WHNP (WP who)) (S (VP (VBD helped) (NP (DT the) (NN student)))))) (VP (VBD was) (NP (DT a) (NN teacher))))
(S (NP (NP (DT the) (NN man)) (SBAR (WHNP (WP who)) (S (VP (VBD built) (NP (DT the) (NN house)))))) (VP (VBD was) (NP (DT a) (NN farmer))))
(S (NP (NP (DT the) (NN boy)) (SBAR (WHNP (WP who)) (S (VP (VBD kicked) (NP (DT the) (NN ball)))))) (VP (VBD ran) (ADVP (RB quickly))))
(S (NP (DT the) (NN cat)) (VP (VBD watched) (NP (NP (DT the) (NN bird)) (SBAR (WHNP (WDT that)) (S (VP (VBD sat) (PP (IN on) (NP (DT the) (NN tree)))))))))
(S (NP (PRP she)) (VP (VBD liked) (NP (NP (DT the) (NN story)) (SBAR (WHNP (WDT that)) (S (NP (DT the) (NN teacher)) (VP (VBD told)))))))
(S (NP (PRP he)) (VP (VBD found) (NP (NP (DT the) (NN letter)) (SBAR (WHNP (WDT that)) (S (NP (DT the) (NN girl)) (VP (VBD wrote)))))))
(S (NP (NP (DT the) (NN cat)) (CC and) (NP (DT the) (NN dog))) (VP (VBD slept) (PP (IN on) (NP (DT the) (NN mat)))))
(S (NP (NP (DT the) (NN boy)) (CC and) (NP (DT the) (NN girl))) (VP (VBD played) (PP (IN in) (NP (DT the) (NN park)))))
(S (NP (NP (NNP john)) (CC and) (NP (NNP mary))) (VP (VBD visited) (NP (DT the) (NN city))))
(S (NP (NP (DT the) (NN man)) (CC and) (NP (DT the) (NN woman))) (VP (VBD read) (NP (DT the) (NNS books))))
(S (NP (DT the) (NN dog)) (VP (VBD chased) (NP (NP (DT the) (NN cat)) (CC and) (NP (DT the) (NN bird)))))
(S (NP (DT the) (NN teacher)) (VP (VBD helped) (NP (NP (DT the) (NN boy)) (CC and) (NP (DT the) (NN girl)))))
(S (NP (DT the) (NN farmer)) (VP (VBD fed) (NP (NP (DT the) (NN horse)) (CC and) (NP (DT the) (NN dog)))))
(S (NP (DT the) (NN child)) (VP (VP (VBD sang)) (CC and) (VP (VBD played))))
(S (NP (DT the) (NN dog)) (VP (VP (VBD ran)) (CC and) (VP (VBD jumped))))
(S (NP (DT the) (NN man)) (VP (VP (VBD opened) (NP (DT the) (NN door))) (CC and) (VP (VBD closed) (NP (DT the) (NN window)))))
(S (NP (DT the) (NN girl)) (VP (VP (VBD read) (NP (DT the) (NN book))) (CC and) (VP (VBD wrote) (NP (DT a) (NN letter)))))
(S (NP (DT the) (NN cat)) (VP (VP (VBD sat) (PP (IN on) (NP (DT the) (NN mat)))) (CC and) (VP (VBD watched) (NP (DT the) (NN bird)))))
(S (S (NP (DT the) (NN dog)) (VP (VBD slept))) (CC and) (S (NP (DT the) (NN cat)) (VP (VBD played))))
(S (S (NP (DT the) (NN boy)) (VP (VBD ran))) (CC but) (S (NP (DT the) (NN girl)) (VP (VBD walked))))
(S (S (NP (DT the) (NN man)) (VP (VBD read) (NP (DT a) (NN book)))) (CC and) (S (NP (DT the) (NN woman)) (VP (VBD wrote) (NP (DT a) (NN letter)))))
(S (S (NP (DT the) (NN bird)) (VP (VBD sang))) (CC but) (S (NP (DT the) (NN cat)) (VP (VBD slept))))
(S (NP (DT the) (NN dog)) (VP (VBZ is) (ADJP (ADJP (JJ big)) (CC and) (ADJP (JJ strong)))))
(S (NP (DT the) (NN child)) (VP (VBD was) (ADJP (ADJP (JJ happy)) (CC and) (ADJP (JJ tired)))))
(S (NP (DT the) (NN house)) (VP (VBZ is) (ADJP (ADJP (JJ old)) (CC but) (ADJP (JJ strong)))))
(S (NP (NNP anna)) (VP (VBD walked) (PP (IN in) (NP (NNP london)))))
(S (NP (NNP peter)) (VP (VBD visited) (NP (NNP paris))))
(S (NP (NNP anna)) (VP (VBD gave) (NP (NNP peter)) (NP (DT a) (NN book))))
(S (NP (NNP john)) (VP (VBD walked) (PP (IN from) (NP (DT the) (NN school)))))
(S (NP (DT the) (NN man)) (VP (VBD walked) (PP (IN from) (NP (DT the) (NN house))) (PP (TO to) (NP (DT the) (NN park)))))
(S (NP (DT the) (NN child)) (VP (VBD ran) (PP (IN from) (NP (DT the) (NN tree))) (PP (TO to) (NP (DT the) (NN river)))))
(S (NP (NP (DT the) (NN cat)) (PP (IN on) (NP (DT the) (NN mat)))) (VP (VBZ is) (ADJP (JJ happy))))
(S (NP (NP (DT the) (NN book)) (PP (IN on) (NP (DT the) (NN table)))) (VP (VBD was) (ADJP (JJ old))))
(S (NP (NP (DT the) (NN dog)) (PP (IN in) (NP (DT the) (NN garden)))) (VP (MD can) (VP (VB run) (ADVP (RB quickly)))))
(S (NP (NP (DT the) (NNS birds)) (PP (IN in) (NP (DT the) (NN tree)))) (VP (VBP sing) (ADVP (RB happily))))
(S (NP (DT the) (JJ old) (NN man)) (VP (VBD said) (SBAR (IN that) (S (NP (DT the) (NN garden)) (VP (VBD was) (ADJP (JJ green)))))))
(S (NP (DT the) (JJ young) (NN girl)) (VP (MD will) (VP (VB sing) (NP (DT a) (NN song)))))
(S (NP (NP (DT the) (NN teacher)) (CC and) (NP (DT the) (NNS students))) (VP (VBD walked) (PP (TO to) (NP (DT the) (NN school)))))
(S (NP (PRP they)) (VP (VBD said) (SBAR (IN that) (S (NP (DT the) (NNS dogs)) (VP (VBP are) (ADJP (JJ hungry)))))))
(S (NP (DT the) (NN woman)) (VP (VBD watched) (NP (NP (DT the) (NNS children)) (PP (IN in) (NP (DT the) (NN park))))))
(S (NP (DT the) (NN boy)) (VP (VBD wanted) (S (VP (TO to) (VP (VB be) (NP (DT a) (NN doctor)))))))
(S (NP (DT the) (NN girl)) (VP (MD will) (VP (VB be) (NP (DT a) (NN teacher)))))
(S (NP (PRP it)) (VP (VBZ is) (NP (DT a) (JJ big) (NN city))))
(S (NP (DT the) (NN dog)) (VP (VBD seemed) (ADJP (JJ happy))))
(S (NP (DT the) (NN child)) (VP (VBD looked) (ADJP (JJ tired))))
(S (NP (DT the) (NN man)) (VP (VBD became) (NP (DT a) (NN farmer))))
(S (NP (DT the) (NN woman)) (VP (VBD became) (ADJP (JJ famous))))
"""


def bundled_treebank() -> list[Tree]:
    """The sample trees (raw, n-ary, with POS preterminals)."""
    return [
        parse_ptb(line.strip())
        for line in _TREEBANK.strip().splitlines()
        if line.strip()
    ]


class Pcfg:
    """Maximum-likelihood PCFG over binarized trees.

    Rules: binary ``A -> B C`` (log prob) and lexical ``T -> word``.
    Unknown words score against an open-class back-off distribution
    built from singleton (hapax) tag counts.
    """

    def __init__(self):
        self.binary: dict[tuple[str, str], list[tuple[str, float]]] = {}
        self.lexical: dict[str, list[tuple[str, float]]] = {}
        self.unk: list[tuple[str, float]] = []
        self.root_labels: Counter = Counter()

    @classmethod
    def from_trees(cls, trees: list[Tree]) -> "Pcfg":
        g = cls()
        rule_counts: Counter = Counter()
        lhs_counts: Counter = Counter()
        lex_counts: Counter = Counter()
        tag_counts: Counter = Counter()
        word_freq: Counter = Counter()

        prepared = [binarize(collapse_unaries(t)) for t in trees]
        for t in prepared:
            g.root_labels[t.label] += 1

        def walk(node: Tree):
            # a preterminal in this Tree convention is a LEAF carrying
            # label (the POS tag) + word — parse_ptb builds (DT the) as
            # Tree(label='DT', word='the') with no children
            if node.is_leaf():
                if node.word is not None:
                    w = node.word.lower()
                    lex_counts[(node.label, w)] += 1
                    tag_counts[node.label] += 1
                    word_freq[w] += 1
                return
            if len(node.children) == 1:
                # unary-over-preterminal survives collapse_unaries (it
                # stops at preterminals); fold the chain into the
                # lexicon — the word is tagged with the chain's top
                # label (e.g. NP -> (PRP he) teaches 'he' as NP)
                w = node.children[0].word.lower()
                lex_counts[(node.label, w)] += 1
                tag_counts[node.label] += 1
                word_freq[w] += 1
                return
            assert len(node.children) == 2, "binarize() guarantees arity 2"
            b, c = node.children
            rule_counts[(node.label, b.label, c.label)] += 1
            lhs_counts[node.label] += 1
            for ch in node.children:
                walk(ch)

        for t in prepared:
            walk(t)

        for (a, b, c), n in rule_counts.items():
            g.binary.setdefault((b, c), []).append(
                (a, math.log(n / lhs_counts[a]))
            )
        by_word: dict[str, list[tuple[str, float]]] = defaultdict(list)
        for (tag, w), n in lex_counts.items():
            by_word[w].append((tag, math.log(n / tag_counts[tag])))
        g.lexical = dict(by_word)
        # unknown-word back-off: every observed preterminal tag,
        # weighted by frequency. (Hapax-based open-class estimation is
        # the classic choice but too sparse for a mini-treebank — with
        # ~30 trees whole tag classes have no singleton words.)
        pool = tag_counts
        total = sum(pool.values())
        g.unk = [
            (tag, math.log(n / total) - 2.0)  # -2.0: unk penalty
            for tag, n in pool.items()
        ]
        return g


class CkyParser:
    """Exact Viterbi CKY over a :class:`Pcfg` (binarized grammar)."""

    def __init__(self, grammar: Pcfg):
        self.g = grammar

    def parse(self, tokens: list[str]) -> Tree | None:
        """Best parse as a binary tree (with the binarization's @labels
        intact — downstream consumers train on binarized trees anyway),
        or None when the grammar cannot span the sentence."""
        n = len(tokens)
        if n == 0:
            return None
        g = self.g
        # chart[(i, j)] : label -> (logprob, backpointer)
        chart: list[dict[str, tuple[float, object]]] = [
            {} for _ in range(n * n)
        ]

        def cell(i, j):
            return chart[i * n + (j - 1)]

        for i, tok in enumerate(tokens):
            w = tok.lower()
            entries = g.lexical.get(w, g.unk)
            c = cell(i, i + 1)
            for tag, lp in entries:
                if lp > c.get(tag, (-math.inf, None))[0]:
                    c[tag] = (lp, tok)
        for span in range(2, n + 1):
            for i in range(0, n - span + 1):
                j = i + span
                c = cell(i, j)
                for k in range(i + 1, j):
                    left, right = cell(i, k), cell(k, j)
                    if not left or not right:
                        continue
                    for bl, (blp, _) in left.items():
                        for cl, (clp, _) in right.items():
                            for a, rlp in g.binary.get((bl, cl), ()):
                                p = blp + clp + rlp
                                if p > c.get(a, (-math.inf, None))[0]:
                                    c[a] = (p, (k, bl, cl))
        top = cell(0, n)
        best = None
        for label in top:
            bonus = 0.0 if g.root_labels.get(label) else -5.0
            score = top[label][0] + bonus
            if best is None or score > best[1]:
                best = (label, score)
        if best is None:
            return None

        def build(i, j, label) -> Tree:
            lp, back = cell(i, j)[label]
            if isinstance(back, str):
                # preterminal = leaf with tag + word (parse_ptb convention)
                return Tree(label=label, word=back)
            k, bl, cl = back
            return Tree(
                label=label,
                children=[build(i, k, bl), build(k, j, cl)],
            )

        return build(0, n, best[0])


@functools.lru_cache(maxsize=1)
def default_parser() -> CkyParser:
    """Parser trained on the bundled treebank (built once per process)."""
    return CkyParser(Pcfg.from_trees(bundled_treebank()))

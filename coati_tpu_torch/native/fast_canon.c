/* fast_canon.c — native canonical-SMILES pipeline.
 *
 * C port of the host hot path chem/graph_canon.canonical_smiles
 * (parse -> kekulize -> aromaticity perception -> WL ranks ->
 * tie-break search -> writer), byte-identical to the Python
 * implementation, which remains the spec and the fallback. Every
 * algorithmic choice below mirrors a specific Python function:
 *
 *   parser        chem/selfies_lite.parse_smiles
 *   bridges       chem/selfies_lite._bridges        (iterative Tarjan)
 *   kekulize      chem/selfies_lite.kekulize        (backtracking matching)
 *   implicit H    chem/graph_canon.implicit_hydrogens
 *   SSSR          chem/descriptors.sssr_rings       (BFS + GF(2) echelon)
 *   perception    chem/aromaticity.perceive_aromaticity
 *   WL refine     chem/graph_canon._refine          (61-bit commutative hash)
 *   search        chem/graph_canon._search / _leaf_code / _chi_rank
 *   writer        chem/selfies_lite.write_smiles(order=...)
 *
 * Byte-exactness notes: the WL hash uses Python's arbitrary-precision
 * product masked to 61 bits — uint64 wraparound multiplication yields
 * the identical low 61 bits, so plain C arithmetic matches. All sorts
 * that Python relies on for tie-breaking are stable here too. Any
 * input outside the supported limits (atoms > MAXN, rings > MAXR, a
 * parse error, a kekulization failure) returns a nonzero status and
 * the caller falls back to Python (which raises EncoderError with the
 * same semantics for genuinely invalid input).
 *
 * Verified byte-identical against the Python path by
 * tests/test_fast_canon.py (ChEMBL corpus x permutations, stereo
 * corpus, grammar-soup fuzz).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <stdio.h>

#define MAXN 512    /* atoms */
#define MAXB 1024   /* bonds */
#define MAXR 256    /* SSSR rings */
#define MAXW 16     /* words in a bond bitset (MAXB/64) */
#define MAXDEG 16   /* max neighbors per atom we support */

/* status codes */
#define OK 0
#define ERR_PARSE 1      /* Python would raise EncoderError */
#define ERR_KEKULIZE 2   /* Python would raise EncoderError */
#define ERR_UNSUPPORTED 3 /* outside C limits: fall back to Python */

typedef struct {
    char elem[3];    /* capitalized, NUL-terminated */
    uint8_t aromatic;
    int8_t charge;
    int16_t isotope;
    uint8_t chi;     /* 0 = "", 1 = "@", 2 = "@@" */
    int8_t hcount;   /* -1 = None (implicit) */
    int16_t frag;
} CAtom;

typedef struct {
    int16_t a, b;
    int8_t order;
    uint8_t aromatic;
    int8_t stereo;    /* 0 none, 1 = "/", 2 = "\\" (read a->b) */
    int16_t stereo_at;
} CBond;

typedef struct {
    int n, nb;
    CAtom atoms[MAXN];
    CBond bonds[MAXB];
    /* written-order bond lists (ring-open slots patched at close) */
    int16_t written[MAXN][MAXDEG];
    int8_t nwritten[MAXN];
    uint8_t is_root[MAXN];
    int nfrag;
} CMol;

/* ----------------------------------------------------------- parser */

static int is_lower(char c) { return c >= 'a' && c <= 'z'; }
static int is_upper(char c) { return c >= 'A' && c <= 'Z'; }
static int is_digit(char c) { return c >= '0' && c <= '9'; }

/* aromatic bracket elements (lowercase forms): b c n o p s se as te si */
static int arom_bracket(const char *e, int len) {
    if (len == 1)
        return e[0]=='b'||e[0]=='c'||e[0]=='n'||e[0]=='o'||e[0]=='p'||e[0]=='s';
    if (len == 2)
        return (e[0]=='s'&&e[1]=='e')||(e[0]=='a'&&e[1]=='s')||
               (e[0]=='t'&&e[1]=='e')||(e[0]=='s'&&e[1]=='i');
    return 0;
}

typedef struct {
    int order;
    uint8_t aromatic;
    int8_t stereo;
} PendBond;

static int add_written(CMol *m, int atom, int bi) {
    if (m->nwritten[atom] >= MAXDEG) return -1;
    m->written[atom][m->nwritten[atom]++] = (int16_t)bi;
    return 0;
}

/* returns status */
static int parse_smiles_c(const char *s, CMol *m) {
    int prev = -1;
    PendBond pend; int has_pend = 0;
    /* ring bookkeeping: number -> open entry */
    struct { int atom; PendBond tok; int has_tok; int slot_atom; int slot_pos; int open; } ring[100];
    int stack[MAXN]; int sp = 0;
    int frag = 0;
    memset(ring, 0, sizeof(ring));
    m->n = 0; m->nb = 0; m->nfrag = 0;
    memset(m->nwritten, 0, sizeof(m->nwritten));
    memset(m->is_root, 0, sizeof(m->is_root));

    const char *p = s;
    while (*p) {
        char c = *p;
        if (c == '[') {
            /* bracket atom: [iso? elem chi? Hn? charge? (:map)?] */
            const char *q = p + 1;
            int iso = 0;
            while (is_digit(*q)) { iso = iso * 10 + (*q - '0'); q++; if (iso > 9999) return ERR_PARSE; }
            char elem[3] = {0, 0, 0};
            int elen = 0, arom = 0;
            if (*q == '*') return ERR_PARSE; /* wildcard unsupported */
            if (is_upper(*q)) {
                elem[elen++] = *q++;
                if (is_lower(*q)) elem[elen++] = *q++;
            } else if (is_lower(*q)) {
                char low[3] = {0, 0, 0};
                low[0] = *q++;
                int llen = 1;
                if (is_lower(*q)) { low[1] = *q++; llen = 2; }
                arom = arom_bracket(low, llen);
                elem[0] = (char)(low[0] - 'a' + 'A');
                if (llen == 2) elem[1] = low[1];
                elen = llen;
            } else {
                return ERR_PARSE;
            }
            int chi = 0;
            if (*q == '@') {
                q++;
                chi = 1;
                if (*q == '@') { q++; chi = 2; }
                /* extended chirality (TH/AL/SP) -> Python raises */
                if ((q[0]=='T'&&q[1]=='H') || (q[0]=='A'&&q[1]=='L') ||
                    (q[0]=='S'&&q[1]=='P'))
                    return ERR_PARSE;
            }
            int hcount = 0; /* bracket atoms default to explicit 0 */
            if (*q == 'H') {
                q++;
                if (is_digit(*q)) {
                    hcount = 0;
                    while (is_digit(*q)) { hcount = hcount * 10 + (*q - '0'); q++; if (hcount > 99) return ERR_PARSE; }
                } else {
                    hcount = 1;
                }
            }
            int charge = 0;
            if (*q == '+' || *q == '-') {
                int sign = (*q == '+') ? 1 : -1;
                char sc = *q;
                q++;
                if (*q == sc) { charge = 2 * sign; q++; }
                else if (is_digit(*q)) {
                    int v = 0;
                    while (is_digit(*q)) { v = v * 10 + (*q - '0'); q++; if (v > 99) return ERR_PARSE; }
                    charge = v * sign;
                } else {
                    charge = sign;
                }
            }
            if (*q == ':') { /* atom map: accepted and dropped */
                q++;
                if (!is_digit(*q)) return ERR_PARSE;
                while (is_digit(*q)) q++;
            }
            if (*q != ']') return ERR_PARSE;
            q++;
            if (m->n >= MAXN) return ERR_UNSUPPORTED;
            CAtom *a = &m->atoms[m->n];
            memcpy(a->elem, elem, 3);
            a->aromatic = (uint8_t)arom;
            a->charge = (int8_t)charge;
            a->isotope = (int16_t)iso;
            a->chi = (uint8_t)chi;
            a->hcount = (int8_t)hcount;
            a->frag = (int16_t)frag;
            int idx = m->n++;
            if (prev < 0) {
                m->is_root[idx] = 1;
            } else {
                if (m->nb >= MAXB) return ERR_UNSUPPORTED;
                CBond *bd = &m->bonds[m->nb];
                if (has_pend) {
                    bd->order = (int8_t)pend.order;
                    bd->aromatic = pend.aromatic;
                    bd->stereo = pend.stereo;
                    bd->stereo_at = (int16_t)prev;
                } else {
                    bd->order = 1;
                    bd->aromatic = m->atoms[prev].aromatic && a->aromatic;
                    bd->stereo = 0;
                    bd->stereo_at = -1;
                }
                bd->a = (int16_t)prev; bd->b = (int16_t)idx;
                if (add_written(m, prev, m->nb) || add_written(m, idx, m->nb))
                    return ERR_UNSUPPORTED;
                m->nb++;
            }
            has_pend = 0;
            prev = idx;
            p = q;
        } else if ((c == 'C' && p[1] == 'l') || (c == 'B' && p[1] == 'r') ||
                   (c=='B'||c=='C'||c=='N'||c=='O'||c=='P'||c=='S'||c=='F'||c=='I') ||
                   (c=='b'||c=='c'||c=='n'||c=='o'||c=='p'||c=='s')) {
            char elem[3] = {0, 0, 0};
            int arom = 0;
            if (c == 'C' && p[1] == 'l') { elem[0]='C'; elem[1]='l'; p += 2; }
            else if (c == 'B' && p[1] == 'r') { elem[0]='B'; elem[1]='r'; p += 2; }
            else if (is_upper(c)) { elem[0] = c; p++; }
            else { elem[0] = (char)(c - 'a' + 'A'); arom = 1; p++; }
            if (m->n >= MAXN) return ERR_UNSUPPORTED;
            CAtom *a = &m->atoms[m->n];
            memcpy(a->elem, elem, 3);
            a->aromatic = (uint8_t)arom;
            a->charge = 0; a->isotope = 0; a->chi = 0;
            a->hcount = -1; /* implicit */
            a->frag = (int16_t)frag;
            int idx = m->n++;
            if (prev < 0) {
                m->is_root[idx] = 1;
            } else {
                if (m->nb >= MAXB) return ERR_UNSUPPORTED;
                CBond *bd = &m->bonds[m->nb];
                if (has_pend) {
                    bd->order = (int8_t)pend.order;
                    bd->aromatic = pend.aromatic;
                    bd->stereo = pend.stereo;
                    bd->stereo_at = (int16_t)prev;
                } else {
                    bd->order = 1;
                    bd->aromatic = m->atoms[prev].aromatic && a->aromatic;
                    bd->stereo = 0;
                    bd->stereo_at = -1;
                }
                bd->a = (int16_t)prev; bd->b = (int16_t)idx;
                if (add_written(m, prev, m->nb) || add_written(m, idx, m->nb))
                    return ERR_UNSUPPORTED;
                m->nb++;
            }
            has_pend = 0;
            prev = idx;
        } else if (c == '-' || c == '=' || c == '#' || c == ':') {
            if (has_pend) return ERR_PARSE;
            pend.order = (c == '=') ? 2 : (c == '#') ? 3 : 1;
            pend.aromatic = (c == ':');
            pend.stereo = 0;
            has_pend = 1;
            p++;
        } else if (c == '$') {
            return ERR_PARSE; /* quadruple bonds unsupported */
        } else if (c == '/' || c == '\\') {
            if (has_pend) return ERR_PARSE;
            pend.order = 1; pend.aromatic = 0;
            pend.stereo = (c == '/') ? 1 : 2;
            has_pend = 1;
            p++;
        } else if (c == '(') {
            if (prev < 0) return ERR_PARSE;
            if (sp >= MAXN) return ERR_UNSUPPORTED;
            stack[sp++] = prev;
            p++;
        } else if (c == ')') {
            if (sp == 0) return ERR_PARSE;
            prev = stack[--sp];
            p++;
        } else if (is_digit(c) || c == '%') {
            int num;
            if (c == '%') {
                if (!is_digit(p[1]) || !is_digit(p[2])) return ERR_PARSE;
                num = (p[1]-'0') * 10 + (p[2]-'0');
                p += 3;
            } else {
                num = c - '0';
                p++;
            }
            if (prev < 0) return ERR_PARSE;
            if (ring[num].open) {
                int a = ring[num].atom;
                PendBond *tok_a = ring[num].has_tok ? &ring[num].tok : NULL;
                PendBond *tok = has_pend ? &pend : NULL;
                if (tok_a && tok) {
                    if (tok_a->order != tok->order || tok_a->aromatic != tok->aromatic)
                        return ERR_PARSE; /* conflicting ring-bond tokens */
                }
                PendBond *use = tok ? tok : tok_a;
                int stereo_at = tok ? prev : a;
                if (a == prev) return ERR_PARSE; /* self-ring */
                /* a ring bond joining two '.'-separated fragments makes
                 * frag ids inconsistent with connectivity; the Python
                 * writer raises on such molecules — defer to it */
                if (m->atoms[a].frag != m->atoms[prev].frag)
                    return ERR_UNSUPPORTED;
                if (m->nb >= MAXB) return ERR_UNSUPPORTED;
                CBond *bd = &m->bonds[m->nb];
                bd->a = (int16_t)a; bd->b = (int16_t)prev;
                if (use) {
                    bd->order = (int8_t)use->order;
                    bd->aromatic = use->aromatic;
                    bd->stereo = use->stereo;
                    bd->stereo_at = (int16_t)(use->stereo ? stereo_at : stereo_at);
                } else {
                    bd->order = 1;
                    bd->aromatic = m->atoms[a].aromatic && m->atoms[prev].aromatic;
                    bd->stereo = 0;
                    bd->stereo_at = (int16_t)stereo_at;
                }
                if (!use) bd->stereo_at = -1;
                /* patch the opener's written slot, append at closer */
                m->written[ring[num].slot_atom][ring[num].slot_pos] = (int16_t)m->nb;
                if (add_written(m, prev, m->nb)) return ERR_UNSUPPORTED;
                m->nb++;
                ring[num].open = 0;
                has_pend = 0;
            } else {
                ring[num].open = 1;
                ring[num].atom = prev;
                ring[num].has_tok = has_pend;
                if (has_pend) ring[num].tok = pend;
                ring[num].slot_atom = prev;
                ring[num].slot_pos = m->nwritten[prev];
                if (add_written(m, prev, -1)) return ERR_UNSUPPORTED;
                has_pend = 0;
            }
        } else if (c == '.') {
            if (has_pend || sp > 0) return ERR_PARSE;
            prev = -1;
            frag++;
            p++;
        } else if (c == ' ' || c == '\t') {
            p++;
        } else {
            return ERR_PARSE;
        }
    }
    if (sp != 0) return ERR_PARSE;
    for (int i = 0; i < 100; i++) if (ring[i].open) return ERR_PARSE;
    if (has_pend) return ERR_PARSE;
    if (m->n == 0) return ERR_PARSE;
    m->nfrag = frag + 1;
    return OK;
}

/* ------------------------------------------------------ adjacency */

typedef struct {
    int16_t nbr[MAXDEG];
    int16_t bond[MAXDEG];
    int8_t deg;
} Adj;

/* neighbor lists in bond-index order (Mol.neighbors semantics) */
static int build_adj(const CMol *m, Adj *adj) {
    for (int i = 0; i < m->n; i++) adj[i].deg = 0;
    for (int bi = 0; bi < m->nb; bi++) {
        int a = m->bonds[bi].a, b = m->bonds[bi].b;
        if (adj[a].deg >= MAXDEG || adj[b].deg >= MAXDEG) return ERR_UNSUPPORTED;
        adj[a].nbr[adj[a].deg] = (int16_t)b; adj[a].bond[adj[a].deg++] = (int16_t)bi;
        adj[b].nbr[adj[b].deg] = (int16_t)a; adj[b].bond[adj[b].deg++] = (int16_t)bi;
    }
    return OK;
}

/* ------------------------------------------------------ bridges
 * selfies_lite._bridges: iterative Tarjan; out = set of bridge bonds.
 * Only set membership matters (no ordering sensitivity). */
static void bridges_c(const CMol *m, const Adj *adj, uint8_t *is_bridge) {
    int disc[MAXN], low[MAXN];
    struct { int u; int pbond; int it; } st[MAXN + 1];
    memset(is_bridge, 0, (size_t)m->nb);
    for (int i = 0; i < m->n; i++) disc[i] = -1;
    int timer = 0;
    for (int root = 0; root < m->n; root++) {
        if (disc[root] != -1) continue;
        int sp = 0;
        st[sp].u = root; st[sp].pbond = -1; st[sp].it = 0; sp++;
        disc[root] = low[root] = timer++;
        while (sp > 0) {
            int u = st[sp-1].u, pbond = st[sp-1].pbond;
            int advanced = 0;
            while (st[sp-1].it < adj[u].deg) {
                int k = st[sp-1].it++;
                int v = adj[u].nbr[k], bi = adj[u].bond[k];
                if (bi == pbond) continue;
                if (disc[v] == -1) {
                    disc[v] = low[v] = timer++;
                    st[sp].u = v; st[sp].pbond = bi; st[sp].it = 0; sp++;
                    advanced = 1;
                    break;
                }
                if (disc[v] < low[u]) low[u] = disc[v];
            }
            if (!advanced) {
                sp--;
                if (sp > 0) {
                    int pu = st[sp-1].u;
                    if (low[u] < low[pu]) low[pu] = low[u];
                    if (low[u] > disc[pu]) is_bridge[pbond] = 1;
                }
            }
        }
    }
}

/* ------------------------------------------------------ kekulize
 * selfies_lite.kekulize: backtracking perfect matching over "needy"
 * aromatic atoms; pool sorted (stably) by unmatched-neighbor count.
 * Mirrors _needs_double exactly. */

static int needs_double(const CAtom *a, int conn, int has_exo_double,
                        int n_dbl_dummy) {
    (void)n_dbl_dummy;
    int h = a->hcount < 0 ? 0 : a->hcount;
    conn += h;
    if (has_exo_double) return 0;
    const char *e = a->elem;
    int c = a->charge;
    if ((e[0]=='C' && !e[1]) || (e[0]=='S' && e[1]=='i')) {
        return c == 0 ? (conn <= 3) : 0;
    }
    if ((e[0]=='N' && !e[1]) || (e[0]=='P' && !e[1]) ||
        (e[0]=='A' && e[1]=='s')) {
        if (c == 0) return conn == 2;
        if (c == 1) return conn == 3;
        return 0;
    }
    if ((e[0]=='O' && !e[1]) || (e[0]=='S' && !e[1]) ||
        (e[0]=='S' && e[1]=='e') || (e[0]=='T' && e[1]=='e')) {
        return c == 1;
    }
    return 0;
}

typedef struct {
    int16_t cand_nbr[MAXN][MAXDEG];
    int16_t cand_bond[MAXN][MAXDEG];
    int8_t cand_deg[MAXN];
    int16_t matched[MAXN]; /* atom -> bond idx, -1 unmatched */
} KekState;

/* recursive backtracking, pool passed as an index list */
static int kek_backtrack(KekState *ks, int16_t *pool, int pool_len) {
    /* filter already-matched */
    int16_t filt[MAXN];
    int fl = 0;
    for (int i = 0; i < pool_len; i++)
        if (ks->matched[pool[i]] < 0) filt[fl++] = pool[i];
    if (fl == 0) return 1;
    /* stable sort by count of unmatched neighbors (insertion sort) */
    int key[MAXN];
    for (int i = 0; i < fl; i++) {
        int a = filt[i], cnt = 0;
        for (int k = 0; k < ks->cand_deg[a]; k++)
            if (ks->matched[ks->cand_nbr[a][k]] < 0) cnt++;
        key[i] = cnt;
    }
    for (int i = 1; i < fl; i++) {
        int16_t v = filt[i]; int kv = key[i]; int j = i - 1;
        while (j >= 0 && key[j] > kv) { filt[j+1] = filt[j]; key[j+1] = key[j]; j--; }
        filt[j+1] = v; key[j+1] = kv;
    }
    int a = filt[0];
    int found_any = 0;
    for (int k = 0; k < ks->cand_deg[a]; k++) {
        int nb = ks->cand_nbr[a][k], bi = ks->cand_bond[a][k];
        if (ks->matched[nb] >= 0) continue;
        found_any = 1;
        ks->matched[a] = (int16_t)bi;
        ks->matched[nb] = (int16_t)bi;
        if (kek_backtrack(ks, filt + 1, fl - 1)) return 1;
        ks->matched[a] = -1;
        ks->matched[nb] = -1;
    }
    (void)found_any;
    return 0;
}

static int kekulize_c(CMol *m, const Adj *adj) {
    int has_arom = 0;
    for (int bi = 0; bi < m->nb; bi++)
        if (m->bonds[bi].aromatic) { has_arom = 1; break; }
    if (!has_arom) return OK;
    uint8_t is_bridge[MAXB];
    bridges_c(m, adj, is_bridge);
    int degree[MAXN]; uint8_t exo_double[MAXN];
    memset(degree, 0, sizeof(int) * (size_t)m->n);
    memset(exo_double, 0, (size_t)m->n);
    for (int bi = 0; bi < m->nb; bi++) {
        CBond *b = &m->bonds[bi];
        degree[b->a]++; degree[b->b]++;
        if (b->order >= 2 && !b->aromatic) {
            exo_double[b->a] = 1; exo_double[b->b] = 1;
        }
    }
    static KekState ks; /* large; single-threaded use per the GIL */
    uint8_t needy[MAXN];
    memset(needy, 0, (size_t)m->n);
    for (int i = 0; i < m->n; i++) {
        ks.cand_deg[i] = 0;
        if (m->atoms[i].aromatic &&
            needs_double(&m->atoms[i], degree[i], exo_double[i], 0))
            needy[i] = 1;
        ks.matched[i] = -1;
    }
    /* candidates: aromatic ring bonds between two needy atoms, in bond
     * order (cand built per-atom in bond order, matching Python) */
    for (int bi = 0; bi < m->nb; bi++) {
        CBond *b = &m->bonds[bi];
        if (!b->aromatic || is_bridge[bi]) continue;
        if (needy[b->a] && needy[b->b]) {
            ks.cand_nbr[b->a][ks.cand_deg[b->a]] = b->b;
            ks.cand_bond[b->a][ks.cand_deg[b->a]++] = (int16_t)bi;
            ks.cand_nbr[b->b][ks.cand_deg[b->b]] = b->a;
            ks.cand_bond[b->b][ks.cand_deg[b->b]++] = (int16_t)bi;
        }
    }
    int16_t pool[MAXN]; int pl = 0;
    for (int i = 0; i < m->n; i++) if (needy[i]) pool[pl++] = (int16_t)i;
    if (!kek_backtrack(&ks, pool, pl)) return ERR_KEKULIZE;
    uint8_t chosen[MAXB];
    memset(chosen, 0, (size_t)m->nb);
    for (int i = 0; i < m->n; i++)
        if (ks.matched[i] >= 0) chosen[ks.matched[i]] = 1;
    for (int bi = 0; bi < m->nb; bi++) {
        if (m->bonds[bi].aromatic) {
            m->bonds[bi].order = chosen[bi] ? 2 : 1;
            m->bonds[bi].aromatic = 0;
        }
    }
    for (int i = 0; i < m->n; i++) m->atoms[i].aromatic = 0;
    return OK;
}

/* ------------------------------------------ implicit hydrogens
 * graph_canon.implicit_hydrogens: kekulize a COPY, then the OpenSMILES
 * organic-subset valence ladder. */

static int valence_ladder(const char *e, int bsum) {
    /* _SMILES_VALENCE; returns implicit H count, or -9999 for
     * "not organic" (caller uses hcount or ladder-less v=bsum). */
    static const struct { const char *e; int l[3]; int nl; } tab[] = {
        {"B", {3,0,0}, 1}, {"C", {4,0,0}, 1}, {"N", {3,5,0}, 2},
        {"O", {2,0,0}, 1}, {"P", {3,5,0}, 2}, {"S", {2,4,6}, 3},
        {"F", {1,0,0}, 1}, {"Cl", {1,0,0}, 1}, {"Br", {1,0,0}, 1},
        {"I", {1,0,0}, 1},
    };
    for (size_t t = 0; t < sizeof(tab)/sizeof(tab[0]); t++) {
        if (strcmp(tab[t].e, e) == 0) {
            for (int k = 0; k < tab[t].nl; k++)
                if (tab[t].l[k] >= bsum) return tab[t].l[k] - bsum;
            return 0; /* v = bsum -> 0 implicit H */
        }
    }
    /* unlisted element: ladder (0,); v = next(x >= bsum) else bsum */
    if (0 >= bsum) return 0 - bsum; /* bsum==0 -> 0 */
    return 0;
}

static int implicit_h_c(const CMol *m, const Adj *adj, int *out_h) {
    /* copy orders/aromatic flags, kekulize the copy */
    static CMol km;
    km = *m;
    int st = kekulize_c(&km, adj);
    if (st != OK) return st;
    int bond_sum[MAXN];
    memset(bond_sum, 0, sizeof(int) * (size_t)m->n);
    for (int bi = 0; bi < km.nb; bi++) {
        bond_sum[km.bonds[bi].a] += km.bonds[bi].order;
        bond_sum[km.bonds[bi].b] += km.bonds[bi].order;
    }
    for (int i = 0; i < km.n; i++) {
        if (km.atoms[i].hcount >= 0) { out_h[i] = km.atoms[i].hcount; continue; }
        out_h[i] = valence_ladder(km.atoms[i].elem, bond_sum[i]);
    }
    return OK;
}

/* ------------------------------------------------------------ SSSR
 * descriptors.sssr_rings: for every non-bridge bond, BFS-shortest
 * cycle through it; dedupe; STABLE sort by length; GF(2) echelon
 * (basis kept numerically descending) keeps rank independent rings.
 * Rings are bond-index bitsets. */

typedef struct { uint64_t w[MAXW]; int len; int gen; } RingBits;

static void bs_zero(uint64_t *w) { memset(w, 0, sizeof(uint64_t) * MAXW); }
static void bs_set(uint64_t *w, int i) { w[i >> 6] |= (uint64_t)1 << (i & 63); }
static int bs_get(const uint64_t *w, int i) { return (int)((w[i >> 6] >> (i & 63)) & 1); }
static int bs_eq(const uint64_t *a, const uint64_t *b) {
    return memcmp(a, b, sizeof(uint64_t) * MAXW) == 0;
}
/* numeric comparison (treat as big integer, high word first) */
static int bs_cmp(const uint64_t *a, const uint64_t *b) {
    for (int i = MAXW - 1; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] > b[i] ? 1 : -1;
    }
    return 0;
}
static int bs_highbit(const uint64_t *w) {
    for (int i = MAXW - 1; i >= 0; i--) {
        if (w[i]) {
            uint64_t x = w[i];
            int b = 63;
            while (!((x >> b) & 1)) b--;
            return i * 64 + b;
        }
    }
    return -1;
}
static void bs_xor(uint64_t *dst, const uint64_t *src) {
    for (int i = 0; i < MAXW; i++) dst[i] ^= src[i];
}
static int bs_any(const uint64_t *w) {
    for (int i = 0; i < MAXW; i++) if (w[i]) return 1;
    return 0;
}
static int bs_intersects(const uint64_t *a, const uint64_t *b) {
    for (int i = 0; i < MAXW; i++) if (a[i] & b[i]) return 1;
    return 0;
}

/* returns ring count or -1 on overflow */
static int sssr_c(const CMol *m, const Adj *adj, const uint8_t *is_bridge,
                  RingBits *rings) {
    int n = m->n;
    int rank = m->nb - n + m->nfrag;
    if (rank <= 0) return 0;
    /* candidates */
    static RingBits cands[MAXB];
    int nc = 0;
    int16_t prev_atom[MAXN], prev_bond[MAXN];
    int16_t q[MAXN];
    for (int bi = 0; bi < m->nb; bi++) {
        if (is_bridge[bi]) continue;
        int A = m->bonds[bi].a, B = m->bonds[bi].b;
        for (int i = 0; i < n; i++) prev_atom[i] = -2; /* unvisited */
        prev_atom[A] = -1; prev_bond[A] = -1;
        int qh = 0, qt = 0;
        q[qt++] = (int16_t)A;
        while (qh < qt && prev_atom[B] == -2) {
            int u = q[qh++];
            for (int k = 0; k < adj[u].deg; k++) {
                int v = adj[u].nbr[k], ebi = adj[u].bond[k];
                if (ebi == bi || prev_atom[v] != -2) continue;
                prev_atom[v] = (int16_t)u; prev_bond[v] = (int16_t)ebi;
                q[qt++] = (int16_t)v;
            }
        }
        if (prev_atom[B] == -2) continue;
        RingBits *r = &cands[nc];
        bs_zero(r->w);
        bs_set(r->w, bi);
        int len = 1;
        int u = B;
        while (u != A) {
            bs_set(r->w, prev_bond[u]);
            len++;
            u = prev_atom[u];
        }
        r->len = len; r->gen = nc;
        /* dedupe against earlier candidates */
        int dup = 0;
        for (int j = 0; j < nc; j++)
            if (cands[j].len == len && bs_eq(cands[j].w, r->w)) { dup = 1; break; }
        if (!dup) nc++;
        if (nc >= MAXB) return -1;
    }
    /* stable sort by length (insertion, keeps generation order) */
    for (int i = 1; i < nc; i++) {
        RingBits v = cands[i];
        int j = i - 1;
        while (j >= 0 && cands[j].len > v.len) { cands[j+1] = cands[j]; j--; }
        cands[j+1] = v;
    }
    /* GF(2) echelon: basis numerically descending */
    static uint64_t basis[MAXR][MAXW];
    int nbasis = 0, chosen = 0;
    for (int ci = 0; ci < nc && chosen < rank; ci++) {
        uint64_t cur[MAXW];
        memcpy(cur, cands[ci].w, sizeof(cur));
        for (int bz = 0; bz < nbasis; bz++) {
            int hi = bs_highbit(basis[bz]);
            if (hi >= 0 && bs_get(cur, hi)) bs_xor(cur, basis[bz]);
        }
        if (bs_any(cur)) {
            if (nbasis >= MAXR || chosen >= MAXR) return -1;
            /* insert keeping numerically descending order */
            int pos = nbasis;
            while (pos > 0 && bs_cmp(basis[pos-1], cur) < 0) {
                memcpy(basis[pos], basis[pos-1], sizeof(uint64_t) * MAXW);
                pos--;
            }
            memcpy(basis[pos], cur, sizeof(uint64_t) * MAXW);
            nbasis++;
            rings[chosen] = cands[ci];
            chosen++;
        }
    }
    return chosen;
}

/* ----------------------------------------- aromaticity perception
 * aromaticity.perceive_aromaticity: kekulize, SSSR, per-atom status,
 * Hueckel over every connected ring subset (enum <= 10 rings/system,
 * else per-ring + whole-system). Order of subset processing does not
 * affect the result (cumulative union), so any enumeration works. */

#define ST_NONCAND (-1)
#define ST_RINGDBL (-2)

static void atom_status(const CMol *m, int i, int conn,
                        const int16_t dbl_nbr[], const int16_t dbl_bond[],
                        int ndbl, int has_triple,
                        const uint64_t *ring_bonds,
                        int *status, int *partner) {
    const CAtom *a = &m->atoms[i];
    const char *e = a->elem;
    int allowed =
        (!e[1] && (e[0]=='B'||e[0]=='C'||e[0]=='N'||e[0]=='O'||e[0]=='P'||e[0]=='S')) ||
        (e[0]=='S'&&e[1]=='e') || (e[0]=='T'&&e[1]=='e') || (e[0]=='A'&&e[1]=='s');
    *partner = -1;
    if (!allowed || has_triple || conn > 3 || ndbl > 1) { *status = ST_NONCAND; return; }
    if (ndbl == 1) {
        int j = dbl_nbr[0], bi = dbl_bond[0];
        if (bs_get(ring_bonds, bi)) { *status = ST_RINGDBL; *partner = j; return; }
        const char *je = m->atoms[j].elem;
        int eneg = (!je[1] && (je[0]=='N'||je[0]=='O'||je[0]=='S')) ||
                   (je[0]=='S'&&je[1]=='e') || (je[0]=='T'&&je[1]=='e');
        *status = eneg ? 0 : ST_NONCAND;
        return;
    }
    int c = a->charge;
    if (e[0]=='C' && !e[1]) {
        *status = (c == -1) ? 2 : (c == 1) ? 0 : ST_NONCAND;
        return;
    }
    if ((e[0]=='N'&&!e[1]) || (e[0]=='P'&&!e[1]) || (e[0]=='A'&&e[1]=='s')) {
        if (c == 0 && conn == 3) { *status = 2; return; }
        if (c == -1 && conn == 2) { *status = 2; return; }
        *status = ST_NONCAND; return;
    }
    if ((e[0]=='O'&&!e[1]) || (e[0]=='S'&&!e[1]) ||
        (e[0]=='S'&&e[1]=='e') || (e[0]=='T'&&e[1]=='e')) {
        *status = (c == 0 && conn == 2) ? 2 : ST_NONCAND;
        return;
    }
    if (e[0]=='B' && !e[1] && c == 0 && conn == 3) { *status = 0; return; }
    *status = ST_NONCAND;
}

#define MAX_ENUM_RINGS 10

typedef struct {
    uint8_t arom_atom[MAXN];
    uint8_t arom_bond[MAXB];
} AromOut;

static int perceive_c(CMol *m, const Adj *adj) {
    int st = kekulize_c(m, adj);
    if (st != OK) return st;
    uint8_t is_bridge[MAXB];
    bridges_c(m, adj, is_bridge);
    static RingBits rings[MAXR];
    int nr = sssr_c(m, adj, is_bridge, rings);
    if (nr < 0) return ERR_UNSUPPORTED;
    if (nr == 0) return OK;

    uint64_t ring_bonds[MAXW];
    bs_zero(ring_bonds);
    for (int r = 0; r < nr; r++) bs_xor(ring_bonds, rings[r].w), (void)0;
    /* xor is wrong for union when overlapping: rebuild via OR */
    bs_zero(ring_bonds);
    for (int r = 0; r < nr; r++)
        for (int i = 0; i < MAXW; i++) ring_bonds[i] |= rings[r].w[i];

    /* ring atom sets */
    static uint64_t ring_atoms[MAXR][MAXW]; /* atom bitsets (MAXN<=1024 ok) */
    for (int r = 0; r < nr; r++) {
        bs_zero(ring_atoms[r]);
        for (int bi = 0; bi < m->nb; bi++) {
            if (bs_get(rings[r].w, bi)) {
                bs_set(ring_atoms[r], m->bonds[bi].a);
                bs_set(ring_atoms[r], m->bonds[bi].b);
            }
        }
    }

    int imp_h[MAXN];
    st = implicit_h_c(m, adj, imp_h);
    if (st != OK) return st;

    int degree[MAXN], has_triple[MAXN], ndbl[MAXN];
    int16_t dbl_nbr[MAXN][4], dbl_bond[MAXN][4];
    memset(degree, 0, sizeof(int) * (size_t)m->n);
    memset(has_triple, 0, sizeof(int) * (size_t)m->n);
    memset(ndbl, 0, sizeof(int) * (size_t)m->n);
    for (int bi = 0; bi < m->nb; bi++) {
        const CBond *b = &m->bonds[bi];
        degree[b->a]++; degree[b->b]++;
        if (b->order == 2) {
            if (ndbl[b->a] < 4) { dbl_nbr[b->a][ndbl[b->a]] = b->b; dbl_bond[b->a][ndbl[b->a]] = (int16_t)bi; }
            ndbl[b->a]++;
            if (ndbl[b->b] < 4) { dbl_nbr[b->b][ndbl[b->b]] = b->a; dbl_bond[b->b][ndbl[b->b]] = (int16_t)bi; }
            ndbl[b->b]++;
        } else if (b->order >= 3) {
            has_triple[b->a] = has_triple[b->b] = 1;
        }
    }

    int status[MAXN], partner[MAXN];
    for (int i = 0; i < m->n; i++) status[i] = ST_NONCAND - 100; /* unset */
    for (int r = 0; r < nr; r++) {
        for (int i = 0; i < m->n; i++) {
            if (bs_get(ring_atoms[r], i) && status[i] == ST_NONCAND - 100) {
                atom_status(m, i, degree[i] + imp_h[i], dbl_nbr[i], dbl_bond[i],
                            ndbl[i], has_triple[i], ring_bonds,
                            &status[i], &partner[i]);
            }
        }
    }

    /* fused systems: union-find over rings sharing a bond */
    int uf[MAXR];
    for (int r = 0; r < nr; r++) uf[r] = r;
    for (int i = 0; i < nr; i++)
        for (int j = i + 1; j < nr; j++)
            if (bs_intersects(rings[i].w, rings[j].w)) {
                int ri = i, rj = j;
                while (uf[ri] != ri) ri = uf[ri];
                while (uf[rj] != rj) rj = uf[rj];
                if (ri != rj) uf[ri] = rj;
            }

    AromOut out;
    memset(&out, 0, sizeof(out));

    /* hueckel over an atom bitset */
    /* returns 1 if the set passes */
    /* (inline helper via macro-free function pointer style) */
    for (int sys_root = 0; sys_root < nr; sys_root++) {
        int rr = sys_root;
        while (uf[rr] != rr) rr = uf[rr];
        if (rr != sys_root) continue; /* process each system at its root */
        int members[MAXR]; int nm = 0;
        for (int r = 0; r < nr; r++) {
            int r2 = r;
            while (uf[r2] != r2) r2 = uf[r2];
            if (r2 == sys_root) members[nm++] = r;
        }
        /* subsets to test: all connected subsets when nm <= 10, else
         * singletons + the whole system */
        /* enumerate via bitmask over members (nm <= 10 -> <= 1024) */
        int total_subsets = (nm <= MAX_ENUM_RINGS) ? (1 << nm) : 0;
        for (int mask = 1; mask < total_subsets || (total_subsets == 0 && mask <= nm + 1); mask++) {
            uint64_t atom_set[MAXW];
            bs_zero(atom_set);
            int sel[MAXR]; int nsel = 0;
            if (total_subsets) {
                for (int k = 0; k < nm; k++)
                    if ((mask >> k) & 1) sel[nsel++] = members[k];
                /* connectivity check: rings in the subset must form one
                 * bond-sharing component (Python grows subsets by
                 * adjacency, so only connected subsets are tested) */
                if (nsel > 1) {
                    int comp[MAXR]; int ncomp = 1; comp[0] = 0;
                    uint8_t in_comp[MAXR]; memset(in_comp, 0, (size_t)nsel);
                    in_comp[0] = 1;
                    int grew = 1;
                    while (grew) {
                        grew = 0;
                        for (int x = 0; x < nsel; x++) {
                            if (in_comp[x]) continue;
                            for (int y = 0; y < nsel; y++) {
                                if (in_comp[y] &&
                                    bs_intersects(rings[sel[x]].w, rings[sel[y]].w)) {
                                    in_comp[x] = 1; ncomp++; grew = 1; break;
                                }
                            }
                        }
                    }
                    if (ncomp != nsel) continue;
                    (void)comp;
                }
            } else {
                /* large system: singletons then the whole set */
                if (mask <= nm) { sel[nsel++] = members[mask - 1]; }
                else { for (int k = 0; k < nm; k++) sel[nsel++] = members[k]; }
            }
            for (int k = 0; k < nsel; k++)
                for (int i = 0; i < MAXW; i++) atom_set[i] |= ring_atoms[sel[k]][i];
            /* hueckel */
            int total = 0, ok = 1;
            for (int i = 0; i < m->n && ok; i++) {
                if (!bs_get(atom_set, i)) continue;
                int stt = status[i];
                if (stt == ST_NONCAND || stt == ST_NONCAND - 100) { ok = 0; break; }
                if (stt == ST_RINGDBL) {
                    if (!bs_get(atom_set, partner[i])) { ok = 0; break; }
                    total += 1;
                } else {
                    total += stt;
                }
            }
            if (ok && total >= 2 && (total - 2) % 4 == 0) {
                for (int i = 0; i < m->n; i++)
                    if (bs_get(atom_set, i)) out.arom_atom[i] = 1;
                for (int k = 0; k < nsel; k++)
                    for (int bi = 0; bi < m->nb; bi++)
                        if (bs_get(rings[sel[k]].w, bi)) out.arom_bond[bi] = 1;
            }
        }
    }

    for (int i = 0; i < m->n; i++) {
        if (out.arom_atom[i]) {
            m->atoms[i].aromatic = 1;
            if (!(m->atoms[i].elem[0]=='C' && !m->atoms[i].elem[1]) &&
                m->atoms[i].hcount < 0 && imp_h[i] > 0)
                m->atoms[i].hcount = (int8_t)imp_h[i];
        }
    }
    for (int bi = 0; bi < m->nb; bi++)
        if (out.arom_bond[bi]) m->bonds[bi].aromatic = 1;
    return OK;
}

/* ------------------------------------------------------ WL ranks
 * graph_canon._refine: commutative 61-bit hash per round; dense ranks
 * over (old_rank, hash). uint64 wraparound multiplication gives the
 * identical low-61 bits as Python's arbitrary-precision product. */

#define M61 (((uint64_t)1 << 61) - 1)

typedef struct {
    int16_t nbr[MAXDEG];
    int8_t label[MAXDEG]; /* 5 if aromatic else order */
    int16_t bond[MAXDEG];
    int8_t deg;
} LAdj;

typedef struct { uint64_t k1, k2; int idx; } RankKey;

static int rankkey_cmp(const void *pa, const void *pb) {
    const RankKey *a = (const RankKey *)pa, *b = (const RankKey *)pb;
    if (a->k1 != b->k1) return a->k1 < b->k1 ? -1 : 1;
    if (a->k2 != b->k2) return a->k2 < b->k2 ? -1 : 1;
    return 0;
}

/* dense ranks from (k1, k2) keys */
static void dense_ranks(RankKey *keys, int n, int16_t *ranks) {
    qsort(keys, (size_t)n, sizeof(RankKey), rankkey_cmp);
    int r = 0;
    for (int i = 0; i < n; i++) {
        if (i > 0 && (keys[i].k1 != keys[i-1].k1 || keys[i].k2 != keys[i-1].k2))
            r++;
        ranks[keys[i].idx] = (int16_t)r;
    }
}

static int count_classes(const int16_t *ranks, int n) {
    uint8_t seen[MAXN];
    memset(seen, 0, (size_t)n);
    int c = 0;
    for (int i = 0; i < n; i++)
        if (!seen[ranks[i]]) { seen[ranks[i]] = 1; c++; }
    return c;
}

static void refine_c(const LAdj *ladj, int n, int16_t *ranks) {
    int n_classes = count_classes(ranks, n);
    RankKey keys[MAXN];
    int16_t newr[MAXN];
    for (;;) {
        for (int i = 0; i < n; i++) {
            uint64_t s = 0;
            for (int k = 0; k < ladj[i].deg; k++) {
                uint64_t x = ((((uint64_t)ladj[i].label[k] << 20) +
                               (uint64_t)ranks[ladj[i].nbr[k]]) *
                              0x9E3779B97F4A7C15ULL) & M61;
                x ^= x >> 29;
                s = (s + x * 0xBF58476D1CE4E5B9ULL) & M61;
            }
            keys[i].k1 = (uint64_t)ranks[i];
            keys[i].k2 = s;
            keys[i].idx = i;
        }
        dense_ranks(keys, n, newr);
        int nc = count_classes(newr, n);
        memcpy(ranks, newr, sizeof(int16_t) * (size_t)n);
        if (nc == n_classes) return;
        n_classes = nc;
    }
}

/* seeds: (element, charge, isotope, aromatic, degree, h, in_ring) —
 * string-first tuple ordering packed into (k1, k2) */
static void seed_ranks(const CMol *m, const LAdj *ladj, const int *h,
                       const uint8_t *in_ring, int16_t *ranks) {
    RankKey keys[MAXN];
    for (int i = 0; i < m->n; i++) {
        const CAtom *a = &m->atoms[i];
        uint64_t elem_code = ((uint64_t)(uint8_t)a->elem[0] << 8) |
                             (uint64_t)(uint8_t)a->elem[1];
        /* charge in [-99, 99] -> offset to non-negative */
        uint64_t k1 = (elem_code << 24) |
                      ((uint64_t)(a->charge + 128) << 16) |
                      ((uint64_t)(uint16_t)a->isotope);
        uint64_t k2 = ((uint64_t)(a->aromatic ? 1 : 0) << 40) |
                      ((uint64_t)ladj[i].deg << 32) |
                      ((uint64_t)(uint32_t)(h[i] + 1) << 8) |
                      (uint64_t)(in_ring[i] ? 1 : 0);
        keys[i].k1 = k1; keys[i].k2 = k2; keys[i].idx = i;
    }
    dense_ranks(keys, m->n, ranks);
}

/* ------------------------------------------------------ search
 * graph_canon._search: branch-and-bound over the first ambiguous cell;
 * leaf code = rank-relabeled attributed graph + normalized stereo.
 * Global-min over the same visited-leaf set as the Python recursion. */

typedef struct {
    const CMol *mol;
    const LAdj *ladj;
    int budget;
    const uint8_t *is_root;
    int64_t *best_code;
    int best_len;
    int has_best;
    int16_t best_ranks[MAXN];
    int64_t *cand_code; /* scratch */
} SearchCtx;

#define TERM (-1)

static int perm_parity_c(const int *src, const int *dst, int len) {
    int pos_of[MAXDEG + 2];
    /* values are bond indices or -1 (H); map via linear search (len<=17) */
    int perm[MAXDEG + 2];
    (void)pos_of;
    for (int i = 0; i < len; i++) {
        int v = dst[i];
        int p = -1;
        for (int j = 0; j < len; j++) if (src[j] == v) { p = j; break; }
        perm[i] = p;
    }
    uint8_t seen[MAXDEG + 2];
    memset(seen, 0, (size_t)len);
    int parity = 0;
    for (int i = 0; i < len; i++) {
        if (seen[i]) continue;
        int j = i, clen = 0;
        while (!seen[j]) { seen[j] = 1; j = perm[j]; clen++; }
        parity ^= (clen - 1) & 1;
    }
    return parity;
}

/* chi marker of atom u normalized against ascending-leaf-rank neighbor
 * order (graph_canon._chi_rank) — returns 0/1/2 */
static int chi_rank_c(const CMol *m, const LAdj *ladj, const int16_t *ranks,
                      int u, const uint8_t *is_root) {
    const CAtom *a = &m->atoms[u];
    if (a->chi == 0) return 0;
    int in_seq[MAXDEG + 2], out_seq[MAXDEG + 2];
    int ni = 0, no = 0;
    for (int k = 0; k < m->nwritten[u]; k++) in_seq[ni++] = m->written[u][k];
    /* biadj sorted by neighbor rank (ranks discrete at leaves; stable
     * on the impossible tie) */
    int idxs[MAXDEG];
    for (int k = 0; k < ladj[u].deg; k++) idxs[k] = k;
    for (int i = 1; i < ladj[u].deg; i++) {
        int v = idxs[i];
        int key = ranks[ladj[u].nbr[v]];
        int j = i - 1;
        while (j >= 0 && ranks[ladj[u].nbr[idxs[j]]] > key) {
            idxs[j+1] = idxs[j]; j--;
        }
        idxs[j+1] = v;
    }
    for (int k = 0; k < ladj[u].deg; k++)
        out_seq[no++] = ladj[u].bond[idxs[k]];
    if (a->hcount == 1) {
        int ipos = is_root[u] ? 0 : 1;
        if (ipos > ni) ipos = ni;
        for (int k = ni; k > ipos; k--) in_seq[k] = in_seq[k-1];
        in_seq[ipos] = -1; ni++;
        for (int k = no; k > 0; k--) out_seq[k] = out_seq[k-1];
        out_seq[0] = -1; no++;
    }
    if (ni < 3 || ni != no) return a->chi;
    /* set equality */
    for (int i = 0; i < ni; i++) {
        int found = 0;
        for (int j = 0; j < no; j++) if (out_seq[j] == in_seq[i]) { found = 1; break; }
        if (!found) return a->chi;
    }
    if (perm_parity_c(in_seq, out_seq, ni))
        return a->chi == 1 ? 2 : 1;
    return a->chi;
}

/* serialize the leaf code; returns token count */
static int leaf_code_c(const CMol *m, const LAdj *ladj, const int16_t *ranks,
                       const uint8_t *is_root, int64_t *code) {
    int n = m->n;
    /* atom records in RANK order */
    int16_t atom_of_rank[MAXN];
    for (int i = 0; i < n; i++) atom_of_rank[ranks[i]] = (int16_t)i;
    int t = 0;
    for (int r = 0; r < n; r++) {
        int u = atom_of_rank[r];
        const CAtom *a = &m->atoms[u];
        code[t++] = ((int64_t)(uint8_t)a->elem[0] << 8) | (int64_t)(uint8_t)a->elem[1];
        code[t++] = a->aromatic ? 1 : 0;
        code[t++] = a->charge;
        code[t++] = a->isotope;
        code[t++] = a->hcount < 0 ? -1 : a->hcount;
        code[t++] = chi_rank_c(m, ladj, ranks, u, is_root);
        /* sorted (label, rank) neighbor pairs */
        int64_t pairs[MAXDEG];
        int np = ladj[u].deg;
        for (int k = 0; k < np; k++)
            pairs[k] = ((int64_t)ladj[u].label[k] << 32) |
                       (int64_t)ranks[ladj[u].nbr[k]];
        for (int i = 1; i < np; i++) {
            int64_t v = pairs[i];
            int j = i - 1;
            while (j >= 0 && pairs[j] > v) { pairs[j+1] = pairs[j]; j--; }
            pairs[j+1] = v;
        }
        for (int k = 0; k < np; k++) {
            code[t++] = (pairs[k] >> 32);        /* label */
            code[t++] = pairs[k] & 0xFFFFFFFF;   /* rank */
        }
        code[t++] = TERM;
    }
    /* stereo triples (min_rank, max_rank, mark) sorted */
    int64_t triples[MAXB];
    int nt = 0;
    for (int bi = 0; bi < m->nb; bi++) {
        const CBond *b = &m->bonds[bi];
        if (!b->stereo) continue;
        int ra = ranks[b->a], rb = ranks[b->b];
        int lo_atom = ra < rb ? b->a : b->b;
        int mark = b->stereo;
        if (b->stereo_at != lo_atom) mark = (mark == 2) ? 1 : 2;
        /* '/' = 0x2F, '\\' = 0x5C for string-comparison order */
        int markc = (mark == 1) ? 0x2F : 0x5C;
        int mn = ra < rb ? ra : rb, mx = ra < rb ? rb : ra;
        triples[nt++] = ((int64_t)mn << 40) | ((int64_t)mx << 16) | markc;
    }
    for (int i = 1; i < nt; i++) {
        int64_t v = triples[i];
        int j = i - 1;
        while (j >= 0 && triples[j] > v) { triples[j+1] = triples[j]; j--; }
        triples[j+1] = v;
    }
    for (int i = 0; i < nt; i++) {
        code[t++] = triples[i] >> 40;
        code[t++] = (triples[i] >> 16) & 0xFFFFFF;
        code[t++] = triples[i] & 0xFFFF;
    }
    code[t++] = TERM;
    return t;
}

static int code_less(const int64_t *a, int alen, const int64_t *b, int blen) {
    int n = alen < blen ? alen : blen;
    for (int i = 0; i < n; i++) {
        if (a[i] != b[i]) return a[i] < b[i];
    }
    return alen < blen;
}

static int first_ambiguous_cell(const int16_t *ranks, int n,
                                int16_t *cell) {
    /* cells keyed by rank, first (lowest rank) with > 1 member; member
     * list in ascending atom index */
    int16_t count[MAXN];
    memset(count, 0, sizeof(int16_t) * (size_t)n);
    for (int i = 0; i < n; i++) count[ranks[i]]++;
    int target = -1;
    for (int r = 0; r < n; r++)
        if (count[r] > 1) { target = r; break; }
    if (target < 0) return 0;
    int nc = 0;
    for (int i = 0; i < n; i++)
        if (ranks[i] == target) cell[nc++] = (int16_t)i;
    return nc;
}

/* _bump: chosen splits into its own class just below its cellmates */
static void bump_c(const int16_t *ranks, int n, int chosen, int16_t *out) {
    RankKey keys[MAXN];
    for (int i = 0; i < n; i++) {
        keys[i].k1 = (uint64_t)ranks[i];
        keys[i].k2 = (i == chosen) ? 0 : 1;
        keys[i].idx = i;
    }
    dense_ranks(keys, n, out);
}

static void search_rec(SearchCtx *sc, int16_t *ranks) {
    int n = sc->mol->n;
    refine_c(sc->ladj, n, ranks);
    int16_t cell[MAXN];
    int nc = first_ambiguous_cell(ranks, n, cell);
    if (nc == 0) {
        int len = leaf_code_c(sc->mol, sc->ladj, ranks, sc->is_root,
                              sc->cand_code);
        if (!sc->has_best ||
            code_less(sc->cand_code, len, sc->best_code, sc->best_len)) {
            memcpy(sc->best_code, sc->cand_code,
                   sizeof(int64_t) * (size_t)len);
            sc->best_len = len;
            sc->has_best = 1;
            memcpy(sc->best_ranks, ranks, sizeof(int16_t) * (size_t)n);
        }
        return;
    }
    int16_t child[MAXN];
    if (sc->budget <= 0) {
        bump_c(ranks, n, cell[0], child);
        search_rec(sc, child);
        return;
    }
    for (int k = 0; k < nc; k++) {
        sc->budget--;
        bump_c(ranks, n, cell[k], child);
        search_rec(sc, child);
        if (sc->budget <= 0) break;
    }
}

/* ------------------------------------------------------ writer
 * selfies_lite.write_smiles(order=...): lowest-rank atom roots each
 * fragment, neighbors visited in ascending rank (Python sorts the
 * list DESCENDING and pops from the end), fragments in ascending
 * min-rank; ring digits from a LIFO free pool; tetrahedral markers
 * re-oriented by written-vs-emitted permutation parity. */

typedef struct {
    const CMol *m;
    const Adj *adj;
    const int16_t *order;
    /* per-run state */
    int16_t tree[MAXN][MAXDEG]; int8_t ntree[MAXN];
    int16_t clos[MAXN][MAXDEG]; int8_t nclos[MAXN];
    int16_t parent_bond[MAXN]; /* -1 none */
    uint8_t used_edge[MAXB];
    uint8_t chi_over_set[MAXN];
    uint8_t chi_over[MAXN];
    int16_t opened_digit[MAXB]; /* -1 = not open */
    int16_t free_digits[MAXB]; int nfree;
    int next_digit;
    char *out; int outcap; int outlen;
    int overflow;
} Writer;

static void w_putc(Writer *w, char c) {
    if (w->outlen + 1 >= w->outcap) { w->overflow = 1; return; }
    w->out[w->outlen++] = c;
}
static void w_puts(Writer *w, const char *s) {
    while (*s) w_putc(w, *s++);
}
static void w_putint(Writer *w, int v) {
    char buf[16];
    snprintf(buf, sizeof(buf), "%d", v);
    w_puts(w, buf);
}

static int organic_subset(const char *e) {
    static const char *tab[] = {"B","C","N","O","P","S","F","Cl","Br","I"};
    for (size_t i = 0; i < sizeof(tab)/sizeof(tab[0]); i++)
        if (strcmp(tab[i], e) == 0) return 1;
    return 0;
}

static void emit_atom(Writer *w, int u) {
    const CAtom *a = &w->m->atoms[u];
    int chi = w->chi_over_set[u] ? w->chi_over[u] : a->chi;
    char sym[3];
    sym[0] = a->elem[0]; sym[1] = a->elem[1]; sym[2] = 0;
    if (a->aromatic) {
        if (sym[0] >= 'A' && sym[0] <= 'Z') sym[0] = (char)(sym[0] - 'A' + 'a');
        if (sym[1] >= 'A' && sym[1] <= 'Z') sym[1] = (char)(sym[1] - 'A' + 'a');
    }
    int bare = organic_subset(a->elem) && a->charge == 0 && a->isotope == 0 &&
               chi == 0 && a->hcount < 0;
    if (bare) { w_puts(w, sym); return; }
    w_putc(w, '[');
    if (a->isotope) w_putint(w, a->isotope);
    w_puts(w, sym);
    if (chi == 1) w_puts(w, "@");
    else if (chi == 2) w_puts(w, "@@");
    int h = a->hcount < 0 ? 0 : a->hcount;
    if (h == 1) w_puts(w, "H");
    else if (h > 1) { w_putc(w, 'H'); w_putint(w, h); }
    if (a->charge) {
        int c = a->charge;
        if (c == 1) w_puts(w, "+");
        else if (c == -1) w_puts(w, "-");
        else {
            w_putc(w, c > 0 ? '+' : '-');
            w_putint(w, c > 0 ? c : -c);
        }
    }
    w_putc(w, ']');
}

static void emit_bond_char(Writer *w, int bi, int frm) {
    const CBond *b = &w->m->bonds[bi];
    if (b->stereo) {
        int mark = b->stereo;
        if (b->stereo_at != frm) mark = (mark == 2) ? 1 : 2;
        w_putc(w, mark == 1 ? '/' : '\\');
        return;
    }
    if (b->aromatic) return;
    if (b->order == 1) {
        if (w->m->atoms[b->a].aromatic && w->m->atoms[b->b].aromatic)
            w_putc(w, '-');
        return;
    }
    w_putc(w, b->order == 2 ? '=' : '#');
}

static void emit_closures(Writer *w, int u) {
    for (int k = 0; k < w->nclos[u]; k++) {
        int cbi = w->clos[u][k];
        if (w->opened_digit[cbi] >= 0) {
            int digit = w->opened_digit[cbi];
            w->opened_digit[cbi] = -1;
            w->free_digits[w->nfree++] = (int16_t)digit;
            emit_bond_char(w, cbi, u);
            if (digit < 10) w_putint(w, digit);
            else { char buf[8]; snprintf(buf, sizeof(buf), "%%%02d", digit); w_puts(w, buf); }
        } else {
            int digit;
            if (w->nfree > 0) digit = w->free_digits[--w->nfree];
            else digit = w->next_digit++;
            w->opened_digit[cbi] = (int16_t)digit;
            if (digit < 10) w_putint(w, digit);
            else { char buf[8]; snprintf(buf, sizeof(buf), "%%%02d", digit); w_puts(w, buf); }
        }
    }
}

static int bond_other(const CMol *m, int bi, int u) {
    return m->bonds[bi].a == u ? m->bonds[bi].b : m->bonds[bi].a;
}

static void walk_emit(Writer *w, int u) {
    for (;;) {
        emit_atom(w, u);
        emit_closures(w, u);
        if (w->overflow) return;
        int nk = w->ntree[u];
        if (nk == 0) return;
        for (int k = 0; k < nk - 1; k++) {
            int cbi = w->tree[u][k];
            w_putc(w, '(');
            emit_bond_char(w, cbi, u);
            walk_emit(w, bond_other(w->m, cbi, u));
            w_putc(w, ')');
            if (w->overflow) return;
        }
        int cbi = w->tree[u][nk - 1];
        emit_bond_char(w, cbi, u);
        u = bond_other(w->m, cbi, u);
    }
}

static int write_smiles_c(const CMol *m, const Adj *adj,
                          const int16_t *order, const uint8_t *is_root,
                          char *out, int outcap) {
    static Writer w;
    w.m = m; w.adj = adj; w.order = order;
    w.out = out; w.outcap = outcap; w.outlen = 0; w.overflow = 0;
    memset(w.opened_digit, -1, sizeof(int16_t) * (size_t)m->nb);
    w.nfree = 0; w.next_digit = 1;
    memset(w.used_edge, 0, (size_t)m->nb);
    memset(w.ntree, 0, (size_t)m->n);
    memset(w.nclos, 0, (size_t)m->n);
    memset(w.chi_over_set, 0, (size_t)m->n);
    for (int i = 0; i < m->n; i++) w.parent_bond[i] = -1;

    /* fragments ordered by min rank */
    int16_t frag_root[MAXN]; /* per frag id: its min-rank atom */
    int16_t frag_min[MAXN];
    for (int f = 0; f < m->nfrag; f++) { frag_root[f] = -1; frag_min[f] = 0x7FFF; }
    for (int i = 0; i < m->n; i++) {
        int f = m->atoms[i].frag;
        if (order[i] < frag_min[f]) { frag_min[f] = order[i]; frag_root[f] = (int16_t)i; }
    }
    int16_t frag_ids[MAXN];
    for (int f = 0; f < m->nfrag; f++) frag_ids[f] = (int16_t)f;
    for (int i = 1; i < m->nfrag; i++) {
        int16_t v = frag_ids[i];
        int key = frag_min[v];
        int j = i - 1;
        while (j >= 0 && frag_min[frag_ids[j]] > key) { frag_ids[j+1] = frag_ids[j]; j--; }
        frag_ids[j+1] = v;
    }

    uint8_t seen[MAXN];
    memset(seen, 0, (size_t)m->n);

    for (int fi = 0; fi < m->nfrag; fi++) {
        int root = frag_root[frag_ids[fi]];
        if (root < 0) continue;
        seen[root] = 1;
        /* DFS replicating Python: per node a DESCENDING-rank-sorted
         * neighbor list popped from the end (stable sort, reverse
         * iteration) */
        struct { int u; int16_t lst[MAXDEG]; int8_t pos; } st[MAXN];
        int sp = 0;
        {
            st[0].u = root;
            int d = adj[root].deg;
            int16_t idxs[MAXDEG];
            for (int k = 0; k < d; k++) idxs[k] = (int16_t)k;
            for (int i = 1; i < d; i++) { /* stable sort DESC by rank */
                int16_t v = idxs[i];
                int key = order[adj[root].nbr[v]];
                int j = i - 1;
                while (j >= 0 && order[adj[root].nbr[idxs[j]]] < key) {
                    idxs[j+1] = idxs[j]; j--;
                }
                idxs[j+1] = v;
            }
            for (int k = 0; k < d; k++) st[0].lst[k] = idxs[k];
            st[0].pos = (int8_t)d; /* pop from the end */
            sp = 1;
        }
        while (sp > 0) {
            int u = st[sp-1].u;
            int advanced = 0;
            while (st[sp-1].pos > 0) {
                int k = st[sp-1].lst[--st[sp-1].pos];
                int v = adj[u].nbr[k], bi = adj[u].bond[k];
                if (w.used_edge[bi]) continue;
                w.used_edge[bi] = 1;
                if (seen[v]) {
                    w.clos[u][w.nclos[u]++] = (int16_t)bi;
                    w.clos[v][w.nclos[v]++] = (int16_t)bi;
                    continue;
                }
                seen[v] = 1;
                w.tree[u][w.ntree[u]++] = (int16_t)bi;
                w.parent_bond[v] = (int16_t)bi;
                int d = adj[v].deg;
                int16_t idxs[MAXDEG];
                for (int kk = 0; kk < d; kk++) idxs[kk] = (int16_t)kk;
                for (int i = 1; i < d; i++) {
                    int16_t vv = idxs[i];
                    int key = order[adj[v].nbr[vv]];
                    int j = i - 1;
                    while (j >= 0 && order[adj[v].nbr[idxs[j]]] < key) {
                        idxs[j+1] = idxs[j]; j--;
                    }
                    idxs[j+1] = vv;
                }
                st[sp].u = v;
                for (int kk = 0; kk < d; kk++) st[sp].lst[kk] = idxs[kk];
                st[sp].pos = (int8_t)d;
                sp++;
                advanced = 1;
                break;
            }
            if (!advanced) sp--;
        }
        /* chi re-orientation for this fragment */
        for (int u = 0; u < m->n; u++) {
            if (m->atoms[u].frag != frag_ids[fi]) continue;
            const CAtom *a = &m->atoms[u];
            if (a->chi == 0) continue;
            int in_seq[MAXDEG + 2], out_seq[MAXDEG + 2];
            int ni = 0, no = 0;
            for (int k = 0; k < m->nwritten[u]; k++) in_seq[ni++] = m->written[u][k];
            if (w.parent_bond[u] >= 0) out_seq[no++] = w.parent_bond[u];
            for (int k = 0; k < w.nclos[u]; k++) out_seq[no++] = w.clos[u][k];
            for (int k = 0; k < w.ntree[u]; k++) out_seq[no++] = w.tree[u][k];
            if (a->hcount == 1) {
                int ip = is_root[u] ? 0 : 1;
                if (ip > ni) ip = ni;
                for (int k = ni; k > ip; k--) in_seq[k] = in_seq[k-1];
                in_seq[ip] = -1; ni++;
                int op = (w.parent_bond[u] >= 0) ? 1 : 0;
                if (op > no) op = no;
                for (int k = no; k > op; k--) out_seq[k] = out_seq[k-1];
                out_seq[op] = -1; no++;
            }
            if (ni < 3 || ni != no) continue;
            int ok = 1;
            for (int i = 0; i < ni && ok; i++) {
                int found = 0;
                for (int j = 0; j < no; j++)
                    if (out_seq[j] == in_seq[i]) { found = 1; break; }
                if (!found) ok = 0;
            }
            if (!ok) continue;
            if (perm_parity_c(in_seq, out_seq, ni)) {
                w.chi_over_set[u] = 1;
                w.chi_over[u] = (uint8_t)(a->chi == 1 ? 2 : 1);
            }
        }
        if (fi > 0) w_putc(&w, '.');
        walk_emit(&w, root);
        if (w.overflow) return -1;
    }
    if (w.outlen >= outcap) return -1;
    out[w.outlen] = 0;
    return w.outlen;
}

/* ------------------------------------------------------ entry point */

int canonical_smiles_native(const char *smiles, int use_chiral, int budget,
                            char *out, int outcap) {
    static CMol m;
    static Adj adj[MAXN];
    int st = parse_smiles_c(smiles, &m);
    if (st != OK) return st;
    st = build_adj(&m, adj);
    if (st != OK) return st;
    st = perceive_c(&m, adj);
    if (st != OK) return st;
    if (!use_chiral) {
        for (int i = 0; i < m.n; i++) m.atoms[i].chi = 0;
        for (int bi = 0; bi < m.nb; bi++) {
            m.bonds[bi].stereo = 0;
            m.bonds[bi].stereo_at = -1;
        }
    } else {
        /* strip degenerate @/@@ (fewer than 3 written neighbors incl.
         * one explicit H) — graph_canon._canonical_cached */
        for (int i = 0; i < m.n; i++) {
            if (m.atoms[i].chi) {
                int nb = m.nwritten[i] + (m.atoms[i].hcount == 1 ? 1 : 0);
                if (nb < 3) m.atoms[i].chi = 0;
            }
        }
    }
    /* canonical_ranks: implicit H, in_ring via bridges, labeled adj */
    int h[MAXN];
    st = implicit_h_c(&m, adj, h);
    if (st != OK) return st;
    uint8_t is_bridge[MAXB];
    bridges_c(&m, adj, is_bridge);
    uint8_t in_ring[MAXN];
    memset(in_ring, 0, (size_t)m.n);
    for (int bi = 0; bi < m.nb; bi++) {
        if (!is_bridge[bi]) {
            in_ring[m.bonds[bi].a] = 1;
            in_ring[m.bonds[bi].b] = 1;
        }
    }
    static LAdj ladj[MAXN];
    for (int i = 0; i < m.n; i++) ladj[i].deg = 0;
    for (int bi = 0; bi < m.nb; bi++) {
        const CBond *b = &m.bonds[bi];
        int lb = b->aromatic ? 5 : b->order;
        LAdj *la = &ladj[b->a]; LAdj *lb2 = &ladj[b->b];
        if (la->deg >= MAXDEG || lb2->deg >= MAXDEG) return ERR_UNSUPPORTED;
        la->nbr[la->deg] = b->b; la->label[la->deg] = (int8_t)lb;
        la->bond[la->deg++] = (int16_t)bi;
        lb2->nbr[lb2->deg] = b->a; lb2->label[lb2->deg] = (int8_t)lb;
        lb2->bond[lb2->deg++] = (int16_t)bi;
    }
    int16_t ranks[MAXN];
    seed_ranks(&m, ladj, h, in_ring, ranks);
    refine_c(ladj, m.n, ranks);

    static int64_t best_code[8 * MAXN + 4 * MAXB + 8];
    static int64_t cand_code[8 * MAXN + 4 * MAXB + 8];
    static SearchCtx sc;
    sc.mol = &m; sc.ladj = ladj; sc.budget = budget;
    sc.is_root = m.is_root;
    sc.best_code = best_code; sc.cand_code = cand_code;
    sc.best_len = 0; sc.has_best = 0;
    int16_t r0[MAXN];
    memcpy(r0, ranks, sizeof(int16_t) * (size_t)m.n);
    search_rec(&sc, r0);
    if (!sc.has_best) return ERR_UNSUPPORTED;

    int len = write_smiles_c(&m, adj, sc.best_ranks, m.is_root, out, outcap);
    if (len < 0) return ERR_UNSUPPORTED;
    return OK;
}
